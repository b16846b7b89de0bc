"""The training step's modules, each against its crnerf_tpu counterpart on
the same numpy inputs: the stochastic sampling, CGNet in training mode,
the loss terms and their gradients, the schedules, Adam and SGD against
optax, PSNR, and the uniform choice of a cached embedding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crnerf_tpu.config import Config as JaxConfig
from crnerf_tpu.core import sampling as jsamp
from crnerf_tpu.models.cgnet import ContextGuidedNetwork as JaxCGNet
from crnerf_tpu.train import losses as jlosses
from crnerf_tpu.train import optim as joptim
from crnerf_tpu.train.metrics import psnr as jax_psnr
from crnerf_tpu_torch import Config
from crnerf_tpu_torch.core import sampling as tsamp
from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork
from crnerf_tpu_torch.train import losses as tlosses
from crnerf_tpu_torch.train import optim as toptim
from crnerf_tpu_torch.train.metrics import psnr
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import select_random_embeddings
from crnerf_tpu_torch.utils import weights as bridge

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- sampling
def test_perturb_zvals_with_the_jax_draw():
    """The JAX function's own uniforms, injected: the same arithmetic in
    fp32 (1e-6 on z of ~4)."""
    rng = np.random.default_rng(0)
    z = np.sort(rng.uniform(0.5, 4.0, (12, 16)), -1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, z.shape, jnp.float32))
    for perturb in (1.0, 0.5):
        want = np.asarray(jsamp.perturb_zvals(key, jnp.asarray(z), perturb))
        got = tsamp.perturb_zvals(_t(z), perturb, u=_t(u)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
        assert np.all(np.diff(got, axis=-1) >= 0)   # bins stay disjoint


def test_perturb_zvals_draws_from_its_generator():
    z = _t(np.linspace(0.5, 4, 16, dtype=np.float32)[None].repeat(4, 0))
    a = tsamp.perturb_zvals(z, 1.0, generator=torch.Generator().manual_seed(1))
    b = tsamp.perturb_zvals(z, 1.0, generator=torch.Generator().manual_seed(1))
    c = tsamp.perturb_zvals(z, 1.0, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.all(a >= z[:, :1]) and torch.all(a <= z[:, -1:])


def test_sample_pdf_stochastic_with_injected_spacings():
    """The JAX draw's exponential spacings e, injected: sorted uniforms
    u = cumsum(e)[:-1] / cumsum(e)[-1], then the inverse CDF (1e-4 on z
    of ~4, as the deterministic case in tests/test_torch_core.py)."""
    rng = np.random.default_rng(3)
    n, b = 32, 14
    zz = np.sort(rng.uniform(0.5, 4.0, (n, b + 2)), -1).astype(np.float32)
    bins = 0.5 * (zz[:, :-1] + zz[:, 1:])
    w = rng.uniform(0, 1, (n, b)).astype(np.float32) ** 4
    key = jax.random.PRNGKey(7)
    e = np.asarray(jax.random.exponential(key, (n, 25), dtype=jnp.float32))
    want = np.asarray(jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w),
                                       24, det=False))
    got = tsamp.sample_pdf(_t(bins), _t(w), 24, det=False, e=_t(e)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.all(np.diff(got, axis=-1) >= 0)       # ascending: a merge sorts
    u = tsamp.sorted_uniforms(_t(e)).numpy()
    assert u.shape == (n, 24) and np.all(np.diff(u, axis=-1) > 0)
    assert u.min() > 0 and u.max() < 1


def test_sample_pdf_draws_from_its_generator():
    bins = _t(np.linspace(0.5, 4, 17, dtype=np.float32)[None].repeat(8, 0))
    w = torch.ones(8, 16)
    a = tsamp.sample_pdf(bins, w, 32, det=False,
                         generator=torch.Generator().manual_seed(4))
    b = tsamp.sample_pdf(bins, w, 32, det=False,
                         generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b)
    assert torch.all(a[:, 1:] >= a[:, :-1])
    # flat weights: the samples are uniform over the bins' span
    assert abs(float(a.mean()) - 2.25) < 0.15


# ------------------------------------------------------------------- CGNet
@pytest.fixture(scope="module")
def cgnet_case():
    net = JaxCGNet(classes=1, M=2, N=2, input_channel=3)
    v = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 48, 64, 3)),
                 train=False)
    rng = np.random.default_rng(0)
    # non-trivial running statistics to start from
    stats = {k: (rng.uniform(0.5, 2.0, a.shape) if k.endswith("var")
                 else rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32)
             for k, a in bridge.flatten(v["batch_stats"]).items()}
    v = {"params": jax.tree.map(np.asarray, v["params"]),
         "batch_stats": bridge.unflatten(stats)}
    x = rng.uniform(0, 1, (2, 48, 64, 3)).astype(np.float32)
    r = rng.normal(size=(2, 48, 64, 1)).astype(np.float32)
    return net, v, x, r


def test_cgnet_training_mode_outputs_and_running_stats(cgnet_case):
    """G = 2 images through the JAX module one image at a time in training
    mode (as its train step maps it), the new statistics averaged over
    the two, against one batched call of the port and
    update_running_stats. fp32: 2e-5 on the mask, 1e-6 on the statistics
    (biased variance, momentum 0.9)."""
    net, v, x, _ = cgnet_case

    def one(img):
        y, mut = net.apply(v, img[None], train=True, mutable=["batch_stats"])
        return y[0], mut["batch_stats"]

    ys, bs = jax.vmap(one)(jnp.asarray(x))
    want_stats = bridge.flatten(
        jax.tree.map(lambda a: np.asarray(a).mean(0), bs))
    port = bridge.load_into(ContextGuidedNetwork(), v).train()
    got = port(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ys),
                               atol=2e-5)
    before = bridge.flatten(bridge.flax_from_state_dict(port)["batch_stats"])
    port.update_running_stats()
    after = bridge.flatten(bridge.flax_from_state_dict(port)["batch_stats"])
    assert set(after) == set(want_stats)
    for k, a in want_stats.items():
        np.testing.assert_allclose(after[k], a, atol=1e-6, rtol=1e-6,
                                   err_msg=k)
        assert np.abs(after[k] - before[k]).max() > 1e-4, k
    # nothing pending: a second call moves nothing
    port.update_running_stats()
    again = bridge.flatten(bridge.flax_from_state_dict(port)["batch_stats"])
    assert all(np.array_equal(again[k], after[k]) for k in after)


def test_cgnet_training_mode_differs_from_batch_statistics(cgnet_case):
    """Per-image statistics, not the batch's: a plain BatchNorm2d over the
    two images gives another mask."""
    _, v, x, _ = cgnet_case
    port = bridge.load_into(ContextGuidedNetwork(), v).train()
    per_image = port(_t(x))
    alone = port(_t(x[:1]))
    np.testing.assert_allclose(per_image[:1].detach().numpy(),
                               alone.detach().numpy(), atol=1e-6)
    port.eval()
    assert float((port(_t(x)) - per_image).abs().max()) > 1e-3


def test_cgnet_training_mode_gradients(cgnet_case):
    """d sum(mask * r) / d params on a zero-mean cotangent r, per leaf:
    1e-3 of the leaf's largest gradient (fp32 sums in another order;
    measured 4e-4)."""
    net, v, x, r = cgnet_case

    def loss(params):
        def one(img, rr):
            y, _ = net.apply({"params": params,
                              "batch_stats": v["batch_stats"]}, img[None],
                             train=True, mutable=["batch_stats"])
            return jnp.sum(y[0] * rr)

        return jnp.sum(jax.vmap(one)(jnp.asarray(x), jnp.asarray(r)))

    want = bridge.flatten(jax.tree.map(np.asarray,
                                       jax.grad(loss)(v["params"])))
    port = bridge.load_into(ContextGuidedNetwork(), v).train()
    (port(_t(x)) * _t(r)).sum().backward()
    got = bridge.flatten(bridge.flax_from_state_dict(port,
                                                     grads=True)["params"])
    assert set(got) == set(want)
    for k, a in want.items():
        np.testing.assert_allclose(got[k], a, atol=1e-3 * np.abs(a).max(),
                                   err_msg=k)


# ------------------------------------------------------------------ losses
LOSS_KEYS = ("a_embedded", "a_embedded_random", "a_embedded_random_rec",
             "out_mask", "rgb_coarse", "rgb_fine")


def _loss_inputs(g=2, b=16, c=4):
    rng = np.random.default_rng(5)
    res = {
        "a_embedded": rng.normal(size=(g, 8, 8, c)),
        "a_embedded_random": rng.normal(size=(g, 8, 8, c)),
        "a_embedded_random_rec": rng.normal(size=(g, 8, 8, c)),
        "out_mask": rng.uniform(0.1, 0.9, (g, b, 1)),
        "rgb_coarse": rng.uniform(0, 1, (g, b, 3)),
        "rgb_fine": rng.uniform(0, 1, (g, b, 3)),
    }
    res = {k: v.astype(np.float32) for k, v in res.items()}
    return res, rng.uniform(0, 1, (g, b, 3)).astype(np.float32)


@pytest.mark.parametrize("mse_on_appearance", [False, True])
@pytest.mark.parametrize("drop", [(), ("out_mask",),
                                  ("a_embedded_random_rec",),
                                  ("rgb_fine",)])
def test_crnerf_loss_terms_and_gradients(mse_on_appearance, drop):
    """Every term per grid, and the gradient of the mean total with
    respect to every result (the coarse term detaches the mask, the fine
    term does not, rec_a_random detaches the chosen embedding). fp32
    means: 1e-6 relative."""
    res, targets = _loss_inputs()
    res = {k: v for k, v in res.items() if k not in drop}
    kw = dict(weightKL=1e-3, weightRecA=1e-2, maskrs_max=5e-2,
              maskrs_min=6e-3, maskrs_k=1e-3, maskrd=1e-3,
              mse_on_appearance=mse_on_appearance)
    step = 700

    def jax_total(r):
        def one(rg, tg):
            d, aw = jlosses.crnerf_loss(rg, tg, step, **kw)
            return sum(d.values()), (d, aw)

        totals, (d, aw) = jax.vmap(one)(r, jnp.asarray(targets))
        return jnp.mean(totals), (d, aw)

    jres = {k: jnp.asarray(v) for k, v in res.items()}
    (_, (jd, jaw)), jgrads = jax.value_and_grad(jax_total, has_aux=True)(jres)
    tres = {k: _t(v).clone().requires_grad_(True) for k, v in res.items()}
    td, taw = tlosses.crnerf_loss(tres, _t(targets), step, **kw)
    assert set(td) == set(jd)
    np.testing.assert_allclose(taw, float(np.asarray(jaw)[0]), rtol=1e-6)
    for k in jd:
        assert td[k].shape == (2,)
        np.testing.assert_allclose(td[k].detach().numpy(), np.asarray(jd[k]),
                                   rtol=1e-5, atol=1e-9, err_msg=k)
    torch.stack([v for v in td.values()]).sum(0).mean().backward()
    for k in res:
        want = np.asarray(jgrads[k])
        got = (tres[k].grad.numpy() if tres[k].grad is not None
               else np.zeros_like(want))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    if "a_embedded_random_rec" in res:
        assert tres["a_embedded_random"].grad is None   # detached


def test_annealing_weight_and_color_loss():
    a = tlosses.ExponentialAnnealingWeight(5e-2, 6e-3, 1e-3)
    b = jlosses.ExponentialAnnealingWeight(5e-2, 6e-3, 1e-3)
    for t in (0, 10, 1000, 5000):
        np.testing.assert_allclose(a(t), float(b(t)), rtol=1e-6)
    assert a(10 ** 6) == 6e-3
    res, targets = _loss_inputs()
    got = tlosses.color_loss({k: _t(v) for k, v in res.items()}, _t(targets))
    for i in range(2):
        want = jlosses.color_loss({k: jnp.asarray(v[i])
                                   for k, v in res.items()},
                                  jnp.asarray(targets[i]))
        np.testing.assert_allclose(float(got[i]), float(want), rtol=1e-6)


def test_psnr():
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(float(psnr(_t(a), _t(b))),
                               float(jax_psnr(jnp.asarray(a),
                                              jnp.asarray(b))), rtol=1e-6)


# --------------------------------------------------------------- schedules
def _cfgs(**kw):
    j = JaxConfig(**kw)
    t = Config(**{f.name: getattr(j, f.name)
                  for f in dataclasses.fields(Config)})
    return j, t


@pytest.mark.parametrize("kw", [
    dict(lr_scheduler="cosine", num_epochs=20),
    dict(lr_scheduler="steplr", decay_step=(2, 5), decay_gamma=0.5),
    dict(lr_scheduler="poly", num_epochs=8, poly_exp=0.9),
    dict(lr_scheduler="cosine", num_epochs=10, warmup_epochs=2,
         warmup_multiplier=3.0),
    dict(lr_scheduler="poly", num_epochs=8, warmup_epochs=1,
         warmup_multiplier=1.0, optimizer="sgd"),
])
def test_lr_schedules(kw):
    """The rate moves once per epoch (floor of step / iterations). The
    JAX schedule computes in fp32, the port in Python floats: 2e-6
    relative, plus 2e-6 of the base rate where the cosine nears its floor
    and the fp32 form cancels."""
    jcfg, tcfg = _cfgs(**kw)
    iters = 7
    js = joptim.make_lr_schedule(jcfg, iters)
    ts = toptim.make_lr_schedule(tcfg, iters)
    for step in (0, 1, 6, 7, 8, 13, 14, 35, 36, 70, 139, 500):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=2e-6,
                                   atol=2e-6 * jcfg.lr, err_msg=str(step))
    assert ts(0) != ts(70)


# -------------------------------------------------------------- optimizers
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32)}


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam"),
    dict(optimizer="adam", weight_decay=1e-2),
    dict(optimizer="sgd", momentum=0.9),
    dict(optimizer="sgd", momentum=0.9, weight_decay=1e-2),
])
def test_three_optimizer_steps_match_optax(kw):
    """Three updates with the rate taken from the schedule at each step,
    on a small tree with fixed gradients, against the JAX package's
    optimizer (optax): where eps sits and how the bias is corrected
    decide the third digit, so 1e-6 on parameters of order 1 pins both."""
    jcfg, tcfg = _cfgs(lr=1e-2, num_epochs=3, **kw)
    iters = 1     # one step per epoch: the rate changes at every step
    tx, _ = joptim.make_optimizer(jcfg, iters)
    params = {k: jnp.asarray(v) for k, v in _tree().items()}
    opt_state = tx.init(params)
    tparams = {k: torch.nn.Parameter(_t(v).clone())
               for k, v in _tree().items()}
    opt, sched = toptim.make_optimizer(tcfg, iters, tparams.values())
    for step in range(3):
        grads = _tree(seed=10 + step)
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = _t(grads[k]).clone()
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for k in params:
            np.testing.assert_allclose(tparams[k].detach().numpy(),
                                       np.asarray(params[k]), atol=1e-6,
                                       err_msg=f"{k} step {step}")
    assert float(np.abs(np.asarray(params["a"]) - _tree()["a"]).max()) > 1e-2


def test_config_rejects_what_is_not_ported():
    with pytest.raises(ValueError, match="not ported"):
        Config(optimizer="ranger")
    with pytest.raises(ValueError, match="not ported"):
        Config(encode_c=True)
    with pytest.raises(ValueError, match="perfect square"):
        Config(batch_size=1000).grid_hw
    assert Config(batch_size=1024).grid_hw == 32
    assert Config(grad_accum_chunks=4).resolved_chunks() == 4
    assert Config(grids_per_step=16).resolved_chunks() == 1


# ------------------------------------------------------- cache selection
def _state(n_vocab=6, hw=2, c=3, valid=()):
    from crnerf_tpu_torch.render.system import CrNerfSystem

    cfg = Config(N_samples=4, N_importance=4, netdepth=2, netwidth=16,
                 nerf_out_dim=c, appearance_wh=(64, 48), N_vocab=n_vocab,
                 use_mask=False)
    system = CrNerfSystem(cfg)
    opt, _ = toptim.make_optimizer(cfg, 1, system.parameters())
    st = TrainState.create(system, opt, n_vocab, hw, c,
                           torch.Generator().manual_seed(0))
    for i in valid:
        st.embedding_cache[i] = float(i + 1)
        st.embedding_valid[i] = True
    st.has_any = bool(valid)
    return st


def test_random_embedding_choice_is_uniform_over_valid_entries():
    st = _state(valid=(1, 4, 5))
    emb = select_random_embeddings(st, 3000)
    assert emb.shape == (3000, 2, 2, 3) and emb.dtype == torch.float32
    picked = emb[:, 0, 0, 0]
    counts = {i: int((picked == i + 1).sum()) for i in (1, 4, 5)}
    assert sum(counts.values()) == 3000          # never an invalid row
    for n in counts.values():                    # 1000 +- 5 sigma
        assert abs(n - 1000) < 5 * (3000 * (1 / 3) * (2 / 3)) ** 0.5
    fixed = select_random_embeddings(st, 2, idx=torch.tensor([4, 1]))
    assert fixed[:, 0, 0, 0].tolist() == [5.0, 2.0]


def test_random_embedding_choice_with_an_empty_cache():
    st = _state()
    emb = select_random_embeddings(st, 4)
    assert emb.shape == (4, 2, 2, 3) and float(emb.abs().max()) == 0.0
