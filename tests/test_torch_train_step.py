"""The training slice as a whole: one and two steps of the port's
make_train_step against the JAX package's, from the same weights (carried
through the bridge), the same batches and the same random draws, at a tiny
fp32 config. The JAX step takes its Pallas route (stash forward and stash
backward kernels) in interpret mode.

The JAX step draws from its state's key. The test replays those key splits
(train/step.py: rng -> step and selection keys, one key per grid;
render/renderer.py: six keys per grid) to get the very numbers, and hands
them to the port's step as ``draws``. Step 1 runs with an empty embedding
cache (the live embedding stands in for the random one), step 2 with the
rows step 1 wrote.

N_emb_xyz=10, as in tests/test_torch_slice.py: at 15 octaves the two
frameworks' one-ulp differences in the perturbed z become ~1e-2 in
sin(2^14 x). tests/test_torch_train_kernels.py holds the kernels' math at
15 octaves on exact inputs.

The two no-stash routes get one whole step each, the same way:
``pallas_stash=False`` (rays-in forward, recompute backward) and
``pertube_cord=True`` (the sample points jittered by 1e-5 * U[0, 1), xyz-in
forward, recompute backward), with the jitter's uniforms replayed from the
fifth and sixth of the renderer's six keys. They too run at N_emb_xyz=10:
the jitter is added to o + d*z, which the two frameworks round one ulp
apart, so at 15 octaves the comparison would measure that ulp and not the
route. tests/test_torch_recompute.py holds both routes' kernels' math at 15
octaves on points that both sides read as the same float32 numbers.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.config import Config
from crnerf_tpu.data.pipeline import TrainPipeline as JaxPipeline
from crnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from crnerf_tpu.models import cgnet as jax_cgnet
from crnerf_tpu.render.system import CrNerfSystem as JaxSystem
from crnerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from crnerf_tpu.train.state import TrainState as JaxTrainState
from crnerf_tpu.train.step import make_train_step as jax_make_train_step
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork
from crnerf_tpu_torch.ops import fused_render
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import make_train_step
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)

G, B = 2, 64
CFG = Config(
    batch_size=B, grids_per_step=G, N_samples=8, N_importance=8, netdepth=6,
    netwidth=32, nerf_out_dim=16, N_emb_xyz=10, N_vocab=8,
    appearance_wh=(64, 48), compute_dtype="float32", pallas_interpret=True,
    num_epochs=2,
)
TCFG = PortConfig(**{f.name: getattr(CFG, f.name)
                     for f in dataclasses.fields(PortConfig)})
N_STEPS = 2


def _flat(tree):
    return bridge.flatten(jax.tree.map(np.asarray, tree))


def replay_draws(rng, valid, pertube=False):
    """The numbers the JAX step draws from ``rng`` with the cache validity
    ``valid``, as the port's ``draws``; with ``pertube`` the uniforms of the
    coordinate jitter too."""
    _, kstep, ksel = jax.random.split(rng, 3)
    n = valid.shape[0]
    idx = [int(jnp.argmax(jnp.where(valid, jax.random.gumbel(k, (n,)),
                                    -jnp.inf)))
           for k in jax.random.split(ksel, G)]
    s, i = CFG.N_samples, CFG.N_importance
    per_grid = {"z_u": [], "noise_coarse": [], "noise_fine": [], "pdf_e": []}
    if pertube:
        per_grid.update(pertube_coarse=[], pertube_fine=[])
    for key in jax.random.split(kstep, G):
        (kf,) = jax.random.split(key, 1)
        kz, kn_c, kn_f, kpdf, kp_c, kp_f = jax.random.split(kf, 6)
        if pertube:
            per_grid["pertube_coarse"].append(
                jax.random.uniform(kp_c, (B, s, 3), jnp.float32))
            per_grid["pertube_fine"].append(
                jax.random.uniform(kp_f, (B, s + i, 3), jnp.float32))
        per_grid["z_u"].append(jax.random.uniform(kz, (B, s), jnp.float32))
        per_grid["noise_coarse"].append(
            CFG.noise_std * jax.random.normal(kn_c, (B, s), jnp.float32))
        per_grid["noise_fine"].append(
            CFG.noise_std * jax.random.normal(kn_f, (B, s + i), jnp.float32))
        per_grid["pdf_e"].append(
            jax.random.exponential(kpdf, (B, i + 1), dtype=jnp.float32))
    draws = {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
             for k, v in per_grid.items()}
    draws["sel_idx"] = torch.tensor(idx, dtype=torch.int64)
    return draws


class _Float64Names:
    """jax.numpy with ``float32`` naming float64."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def cgnet_grads_f64(cgnet_vars, io, norm="batch"):
    """d sum(mask * cot) / d params of CGNet in training mode, one image at
    a time, evaluated at float64 in both packages -> (JAX, port), flat
    leaves. The JAX module names float32 in its conv blocks; for this call
    those names read float64, the program is otherwise the package's.
    ``norm``: CGNet's normalisation, as ``Config.norm``."""
    x, cot = io["x"], io["cot"]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_cgnet, "jnp", _Float64Names())
        mp.setattr(jax_cgnet, "ConvBNPReLU", functools.partial(
            jax_cgnet.ConvBNPReLU, dtype=jnp.float64))
        net = jax_cgnet.ContextGuidedNetwork(classes=1, M=2, N=2,
                                             input_channel=3, norm=norm)
        to64 = lambda t: jax.tree.map(                       # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        stats = to64(cgnet_vars["batch_stats"])

        def loss(params):
            def one(img, c):
                y, _ = net.apply({"params": params, "batch_stats": stats},
                                 img[None], train=True,
                                 mutable=["batch_stats"])
                return jnp.sum(y[0] * c)

            return jnp.sum(jax.vmap(one)(to64(x), to64(cot)))

        want = jax.jit(jax.grad(loss))(to64(cgnet_vars["params"]))
        assert all(a.dtype == jnp.float64 for a in jax.tree.leaves(want))
        want = bridge.flatten(jax.tree.map(np.asarray, want))
    port = bridge.load_into(ContextGuidedNetwork(norm=norm),
                            cgnet_vars).double()
    port.train()
    (port(torch.from_numpy(x).double())
     * torch.from_numpy(cot).double()).sum().backward()
    got = bridge.flatten(bridge.flax_from_state_dict(port,
                                                     grads=True)["params"])
    return want, got


@pytest.fixture(scope="module")
def run():
    """Both packages through N_STEPS steps; per step the JAX state and
    metrics, the draws it used, and the port's state and metrics."""
    scene = jax_scene(n_train=4, n_test=1, img_wh=(24, 18),
                      appearance_wh=CFG.appearance_wh)
    pipe = JaxPipeline(scene, batch_size=B)
    batches = [pipe.make_global_batch(0, i, G) for i in range(N_STEPS)]
    jsys = JaxSystem(CFG)
    variables = jsys.init(jax.random.PRNGKey(0))
    tx, sched = jax_make_optimizer(CFG, pipe.iterations)
    jstate = JaxTrainState.create(
        variables, tx.init(variables["params"]), n_vocab=CFG.N_vocab,
        embed_hw=32, embed_c=CFG.nerf_out_dim, rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jsys, tx, sched, grids_per_step=G,
                                        grad_accum_chunks=1))

    def port_state():
        system = bridge.load_into(CrNerfSystem(TCFG),
                                  jax.tree.map(np.asarray, variables))
        opt, psched = make_optimizer(TCFG, pipe.iterations,
                                     system.parameters())
        return TrainState.create(system, opt, TCFG.N_vocab, 32,
                                 TCFG.nerf_out_dim), psched

    pstate, psched = port_state()
    pstep = make_train_step(pstate.system, pstate.optimizer, psched, G, 1)
    # CGNet's input and the cotangent of its mask in step 1, for
    # test_cgnet_gradients_on_the_step_cotangent_at_float64
    cgnet_io = {}

    def capture(_, inputs, out):
        def keep(g):
            cgnet_io["cot"] = g.numpy().copy()

        cgnet_io["x"] = inputs[0].detach().numpy().copy()
        out.register_hook(keep)

    hook = pstate.system.implicit_mask.register_forward_hook(capture)
    steps = []
    launches = dict(fused_render.LAUNCH_COUNTS)
    for b in batches:
        draws = replay_draws(jstate.rng, jstate.embedding_valid)
        p_before = _flat(jstate.params)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()
                                    if k != "image_idx"})
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        pstate, pm = pstep(pstate, tb, draws)
        hook.remove()
        port_vars = bridge.flax_from_state_dict(pstate.system)
        steps.append(dict(
            draws=draws, batch=tb, jax_before=p_before,
            jax_params=_flat(jstate.params),
            jax_stats=_flat(jstate.batch_stats),
            jax_mu=_flat(jstate.opt_state[0].mu),
            jax_cache=np.asarray(jstate.embedding_cache),
            jax_valid=np.asarray(jstate.embedding_valid),
            jax_metrics={k: float(v) for k, v in jm.items()},
            port_params=bridge.flatten(port_vars["params"]),
            port_stats=bridge.flatten(port_vars["batch_stats"]),
            port_grads=bridge.flatten(bridge.flax_from_state_dict(
                pstate.system, grads=True)["params"]),
            port_cache=pstate.embedding_cache.numpy().copy(),
            port_valid=pstate.embedding_valid.numpy().copy(),
            port_metrics={k: float(v) for k, v in pm.items()},
        ))
    assert fused_render.LAUNCH_COUNTS == launches   # CPU: plain versions
    cgnet_vars = {k: jax.tree.map(np.asarray, variables[k]["implicit_mask"])
                  for k in ("params", "batch_stats")}
    return dict(steps=steps, port_state=port_state, psched=psched,
                lr=float(sched(0)), cgnet_io=cgnet_io,
                cgnet_f64=cgnet_grads_f64(cgnet_vars, cgnet_io))


@pytest.mark.parametrize("i", range(N_STEPS))
def test_metrics_match(run, i):
    """Every metric of the step, same keys. Loss terms are means of fp32
    values of order 1e-2 and below: 1e-4 relative + 1e-7 absolute covers
    summation order and the sin/cos of slightly different z; PSNR 1e-3
    dB. Step 2 starts from parameters that already differ (Adam moves an
    element whose gradient is rounding noise by up to lr in either
    direction, see test_parameter_deltas_match): 1e-3 relative, 1e-2 dB."""
    jm, pm = run["steps"][i]["jax_metrics"], run["steps"][i]["port_metrics"]
    assert set(jm) == set(pm)
    rtol = 1e-4 if i == 0 else 1e-3
    for k in jm:
        tol = dict(rtol=rtol, atol=10 * rtol) if k == "psnr" else dict(
            rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)
    assert jm["loss/rec_a_random"] > 0


def _jax_grads(step, i):
    """Adam's first moment after step 1 is (1 - b1) g: the JAX step's
    gradient, leaf by leaf."""
    assert i == 0
    return {k: v / 0.1 for k, v in step["jax_mu"].items()}


def test_per_leaf_gradients_match(run):
    """Step 1 (empty cache: the random branch runs on the live embedding,
    with gradient). Per leaf: 2e-3 of the leaf's largest gradient plus
    1e-7 (fp32 summation order; sin/cos of 2^9 x at z values one ulp
    apart). CGNet's leaves get 5e-2 here, and that slack is the JAX side's:
    test_cgnet_gradients_on_the_step_cotangent_at_float64 holds the port's
    fp32 CGNet gradients to 5e-4 of a float64 evaluation on which both
    packages agree, and measures the JAX step's fp32 gradients 3.7e-2 off
    it (level3_0.reduce)."""
    step = run["steps"][0]
    jg, pg = _jax_grads(step, 0), step["port_grads"]
    assert set(jg) == set(pg)
    for k in jg:
        assert jg[k].shape == pg[k].shape, k
        scale = np.abs(jg[k]).max()
        rel = 5e-2 if k.startswith("implicit_mask.") else 2e-3
        np.testing.assert_allclose(pg[k], jg[k], atol=rel * scale + 1e-7,
                                   err_msg=k)
    assert sum(float(np.abs(v).max()) > 0 for v in jg.values()) > 100


def _worst(a, b):
    """Largest difference of a leaf of ``a`` from ``b``'s, over the largest
    entry of ``b``'s leaf."""
    return max(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max() for k in b)


def test_cgnet_gradients_on_the_step_cotangent_at_float64(run):
    """Where the CGNet slack of test_per_leaf_gradients_match comes from.
    On step 1's own mask cotangent, at float64, the two packages' CGNet
    gradients agree to 1e-9 of each leaf's largest (measured 6e-13): the
    training-mode normalisation (per-image statistics, biased variance,
    the clamp) is the same function. Against that reference the port's
    fp32 step gradients stay within 5e-4 (measured 9.2e-5), and the JAX
    step's fp32 gradients are off by up to 3.7e-2 (bound 5e-2): the
    difference between the packages at fp32 is fp32 evaluation on the JAX
    side's CPU backend, not another function."""
    want, got = run["cgnet_f64"]
    assert set(want) == set(got) and len(want) > 50
    assert got["classifier.kernel"].dtype == np.float64
    assert _worst(got, want) <= 1e-9
    pre = "implicit_mask."
    step = run["steps"][0]
    port32 = {k[len(pre):]: v for k, v in step["port_grads"].items()
              if k.startswith(pre)}
    jax32 = {k[len(pre):]: v for k, v in _jax_grads(step, 0).items()
             if k.startswith(pre)}
    assert set(port32) == set(want) == set(jax32)
    assert _worst(port32, want) <= 5e-4
    assert 5e-3 < _worst(jax32, want) <= 5e-2


@pytest.mark.parametrize("i", range(N_STEPS))
def test_parameter_deltas_match(run, i):
    """Adam's update is -lr m^ / (sqrt(v^) + 1e-8): where a gradient is
    below ~1e-6 its sign and size are rounding noise and the update can be
    anything in [-lr, lr]. So: every element within 2 lr; elements whose
    step-1 gradient exceeds 1e-5 within 2 % of lr. CGNet's leaves are not
    held to the JAX step's deltas (its fp32 gradients carry percent-level
    noise, which flips the sign of small ones) but, in step 1, to the
    update Adam makes from the float64 gradient on which both packages
    agree: elements above 1e-6, within 2 % of lr (measured 1.2e-4)."""
    step, lr = run["steps"][i], run["lr"]
    g0 = _jax_grads(run["steps"][0], 0)
    n_checked = n_cgnet = 0
    for k, new in step["jax_params"].items():
        d_j = new - step["jax_before"][k]
        before = (step["jax_before"][k] if i == 0
                  else run["steps"][i - 1]["port_params"][k])
        d_p = step["port_params"][k] - before
        assert np.abs(d_p - d_j).max() <= 2 * lr + 1e-9, k
        if k.startswith("implicit_mask."):
            g64 = run["cgnet_f64"][0][k[len("implicit_mask."):]]
            big = np.abs(g64) > 1e-6
            if i == 0 and big.any():
                n_cgnet += int(big.sum())
                want = -lr * g64 / (np.abs(g64) + 1e-8)
                np.testing.assert_allclose(d_p[big], want[big],
                                           atol=0.02 * lr, err_msg=k)
            continue
        big = np.abs(g0[k]) > 1e-5
        n_checked += int(big.sum())
        if big.any():
            np.testing.assert_allclose(d_p[big], d_j[big], atol=0.02 * lr,
                                       err_msg=k)
    assert n_checked > 10000 and (i > 0 or n_cgnet > 200000)


@pytest.mark.parametrize("i", range(N_STEPS))
def test_batchnorm_running_stats_match(run, i):
    """CGNet's running mean and (biased) variance after the step: the mean
    over the G grids of per-image statistics, momentum 0.9. fp32: 1e-5
    after step 1; 1e-3 after step 2, whose CGNet weights differ by up to
    lr per element between the two sides (test_parameter_deltas_match)."""
    step = run["steps"][i]
    assert set(step["jax_stats"]) == set(step["port_stats"])
    moved = 0
    tol = 1e-5 if i == 0 else 1e-3
    for k, v in step["jax_stats"].items():
        np.testing.assert_allclose(step["port_stats"][k], v, atol=tol,
                                   rtol=tol, err_msg=k)
        moved += int(np.abs(v - (1.0 if k.endswith("var") else 0.0)).max()
                     > 1e-3)
    assert moved > len(step["jax_stats"]) // 2


@pytest.mark.parametrize("i", range(N_STEPS))
def test_embedding_cache_rows_and_validity_match(run, i):
    step = run["steps"][i]
    np.testing.assert_array_equal(step["port_valid"], step["jax_valid"])
    ts = step["batch"]["ts"][:, 0].numpy()
    assert step["port_valid"][ts].all()
    np.testing.assert_allclose(step["port_cache"], step["jax_cache"],
                               atol=1e-5)
    assert np.abs(step["port_cache"][ts]).max() > 0


def test_second_step_reads_the_filled_cache(run):
    """Step 2's injected rows are valid cache rows written by step 1."""
    idx = run["steps"][1]["draws"]["sel_idx"].numpy()
    assert run["steps"][0]["port_valid"][idx].all()
    assert not run["steps"][0]["jax_valid"].all()


def test_chunked_step_equals_the_unchunked_step(run):
    """C = 2 against C = 1 in the port, same weights, batch and draws: the
    same mean up to fp32 summation order (gradients 1e-4 of the leaf's
    largest: a convolution's weight gradient over a batch of two images is
    summed in another order than two gradients of one image each, plus 1e-9
    for leaves whose whole gradient is a cancellation near 1e-6; metrics
    1e-6 relative), and the same cache rows and running statistics.
    CGNet's leaves get 5e-4 (measured 1e-4, the distance of either from
    the float64 gradient). Both steps run on PyTorch's own CPU
    convolutions: oneDNN's backward for a batch of one image, which is
    what CGNet sees in a chunk of one grid, is 1.2e-2 off the float64
    gradient in CGNet's first layers (1.1e-4 without it)."""
    step = run["steps"][0]
    out = {}
    for c in (1, 2):
        state, psched = run["port_state"]()
        fn = make_train_step(state.system, state.optimizer, psched, G, c)
        with torch.backends.mkldnn.flags(enabled=False):
            state, m = fn(state, step["batch"], step["draws"])
        v = bridge.flax_from_state_dict(state.system, grads=True)
        out[c] = (bridge.flatten(v["params"]),
                  bridge.flatten(v["batch_stats"]),
                  {k: float(x) for k, x in m.items()},
                  state.embedding_cache.numpy().copy())
    for k, g1 in out[1][0].items():
        rel = 5e-4 if k.startswith("implicit_mask.") else 1e-4
        np.testing.assert_allclose(out[2][0][k], g1, err_msg=k,
                                   atol=rel * np.abs(g1).max() + 1e-9)
    want64 = run["cgnet_f64"][0]
    for c in (1, 2):
        got = {k: out[c][0]["implicit_mask." + k] for k in want64}
        assert _worst(got, want64) <= 5e-4, c
    for k, s1 in out[1][1].items():
        np.testing.assert_allclose(out[2][1][k], s1, atol=1e-6, err_msg=k)
    for k, m1 in out[1][2].items():
        np.testing.assert_allclose(out[2][2][k], m1, rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(out[2][3], out[1][3], atol=1e-6)


def test_step_draws_from_its_generator_without_injection(run):
    """No draws given: the state's generator feeds the perturbation, the
    noise, the resampling and the cache choice; two states seeded alike
    take the same step."""
    losses = []
    for _ in range(2):
        state, psched = run["port_state"]()
        state.generator = torch.Generator().manual_seed(5)
        fn = make_train_step(state.system, state.optimizer, psched, G, 1)
        for i in range(2):
            state, m = fn(state, run["steps"][i]["batch"])
        losses.append(float(m["loss"]))
        assert state.step == 2 and state.has_any
    assert losses[0] == losses[1] and np.isfinite(losses[0])


def test_step_rejects_a_batch_of_the_wrong_size(run):
    state, psched = run["port_state"]()
    with pytest.raises(ValueError, match="must divide"):
        make_train_step(state.system, state.optimizer, psched, 3, 2)
    fn = make_train_step(state.system, state.optimizer, psched, 4, 1)
    with pytest.raises(ValueError, match="grids"):
        fn(state, run["steps"][0]["batch"])


ROUTES = {"pallas_stash_off": dict(pallas_stash=False),
          "pertube_cord": dict(pertube_cord=True)}


@pytest.fixture(scope="module", params=list(ROUTES))
def route(request):
    """One step of both packages on a no-stash route, from the same
    weights, batch and draws; the port's calls of its two backwards are
    counted."""
    cfg = dataclasses.replace(CFG, **ROUTES[request.param])
    tcfg = PortConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(PortConfig)})
    assert (tcfg.pallas_stash, tcfg.pertube_cord) == (cfg.pallas_stash,
                                                      cfg.pertube_cord)
    scene = jax_scene(n_train=4, n_test=1, img_wh=(24, 18),
                      appearance_wh=cfg.appearance_wh)
    pipe = JaxPipeline(scene, batch_size=B)
    batch = pipe.make_global_batch(0, 0, G)
    jsys = JaxSystem(cfg)
    variables = jsys.init(jax.random.PRNGKey(0))
    tx, sched = jax_make_optimizer(cfg, pipe.iterations)
    jstate = JaxTrainState.create(
        variables, tx.init(variables["params"]), n_vocab=cfg.N_vocab,
        embed_hw=32, embed_c=cfg.nerf_out_dim, rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jsys, tx, sched, grids_per_step=G,
                                        grad_accum_chunks=1))
    draws = replay_draws(jstate.rng, jstate.embedding_valid,
                         pertube=cfg.pertube_cord)
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()
                                if k != "image_idx"})
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}

    def port_step(step_draws):
        system = bridge.load_into(CrNerfSystem(tcfg),
                                  jax.tree.map(np.asarray, variables))
        opt, psched = make_optimizer(tcfg, pipe.iterations,
                                     system.parameters())
        state = TrainState.create(system, opt, tcfg.N_vocab, 32,
                                  tcfg.nerf_out_dim)
        state, pm = make_train_step(system, opt, psched, G, 1)(
            state, tb, step_draws)
        grads = bridge.flatten(bridge.flax_from_state_dict(
            system, grads=True)["params"])
        return {k: float(v) for k, v in pm.items()}, grads

    calls = {"stash": 0, "recompute": [], "stashes": [], "jitter": []}
    with pytest.MonkeyPatch.context() as mp:
        real_bwd = fused_render.fused_render_bwd
        real_rec = fused_render.fused_render_bwd_recompute
        real_fwd = fused_render.render_fwd

        def count_bwd(*a, **k):
            calls["stash"] += 1
            return real_bwd(*a, **k)

        def count_rec(kw, origins, dirs, z, noise, g_ray, g_w, exact, xyz,
                      slab_rays):
            calls["recompute"].append(None if xyz is None
                                      else tuple(xyz.shape))
            if xyz is not None:
                calls["jitter"].append(
                    xyz - (origins[:, None] + dirs[:, None] * z[..., None]))
            return real_rec(kw, origins, dirs, z, noise, g_ray, g_w, exact,
                            xyz, slab_rays)

        def watch_fwd(*a, **k):
            out = real_fwd(*a, **k)
            calls["stashes"].append(out[2] is not None)
            return out

        mp.setattr(fused_render, "fused_render_bwd", count_bwd)
        mp.setattr(fused_render, "fused_render_bwd_recompute", count_rec)
        mp.setattr(fused_render, "render_fwd", watch_fwd)
        pm, pg = port_step(draws)
    out = dict(name=request.param, cfg=cfg, calls=calls, port_metrics=pm,
               port_grads=pg,
               jax_metrics={k: float(v) for k, v in jm.items()},
               jax_grads={k: v / 0.1
                          for k, v in _flat(jstate.opt_state[0].mu).items()})
    return out


def test_route_metrics_match(route):
    """Every metric of the step on the no-stash routes, bounds as
    test_metrics_match's first step: 1e-4 relative, PSNR 1e-3 dB."""
    jm, pm = route["jax_metrics"], route["port_metrics"]
    assert set(jm) == set(pm)
    for k in jm:
        tol = dict(rtol=1e-4, atol=1e-3) if k == "psnr" else dict(
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)


def test_route_per_leaf_gradients_match(route):
    """Per leaf 2e-3 of the leaf's largest gradient plus 1e-7, CGNet's
    leaves 5e-2, as test_per_leaf_gradients_match (whose docstring says
    where CGNet's slack comes from)."""
    jg, pg = route["jax_grads"], route["port_grads"]
    assert set(jg) == set(pg)
    for k in jg:
        scale = np.abs(jg[k]).max()
        rel = 5e-2 if k.startswith("implicit_mask.") else 2e-3
        np.testing.assert_allclose(pg[k], jg[k], atol=rel * scale + 1e-7,
                                   err_msg=k)
    nerf = [k for k in jg if k.startswith(("nerf_coarse.", "nerf_fine."))]
    assert len(nerf) >= 40
    assert all(float(np.abs(jg[k]).max()) > 0 for k in nerf)


def test_route_goes_through_the_recompute_backward(route):
    """Neither pass keeps a stash and both backwards recompute: rays-in
    with pallas_stash off, xyz-in (N, S, 3) with the jitter."""
    calls, cfg = route["calls"], route["cfg"]
    assert calls["stash"] == 0
    assert calls["stashes"] == [False, False]
    s, i = cfg.N_samples, cfg.N_importance
    if cfg.pertube_cord:
        assert sorted(calls["recompute"]) == [(G * B, s, 3),
                                              (G * B, s + i, 3)]
    else:
        assert calls["recompute"] == [None, None]


def test_the_jitter_reaches_the_kernels(route):
    """The points the backward is handed are o + d*z moved by the injected
    1e-5 * U[0, 1): every displacement within [0, 1e-5] up to an ulp of a
    coordinate of size ~4 (5e-7), their mean 0.5e-5 within 5 %. (At this
    size and with fresh weights the step's loss does not resolve the
    jitter in float32, so the loss cannot show it.) The other route hands
    no points at all."""
    jitter = route["calls"]["jitter"]
    if not route["cfg"].pertube_cord:
        assert jitter == []
        return
    assert len(jitter) == 2
    for d in jitter:
        assert float(d.min()) >= -5e-7 and float(d.max()) <= 1e-5 + 5e-7
        assert abs(float(d.mean()) - 0.5e-5) <= 0.05 * 0.5e-5

