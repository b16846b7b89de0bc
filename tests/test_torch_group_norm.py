"""CGNet's ``norm="group"`` in the port, against the JAX package.

- ``ContextGuidedNetwork(norm="group")``'s forward in training and in eval
  mode against the JAX module's at 64 x 48, fp32: 1e-5 of the largest.
- One and two steps of the port's ``make_train_step`` against the JAX
  step at tests/test_torch_train_step.py's tiny config with
  ``norm="group"`` (its draw replay and its float64 CGNet evaluation,
  imported): the metrics, the per-leaf gradients, CGNet's gradients
  against float64 in both packages, the parameter deltas, the cache, and
  no statistics on either side.
- A ``weights.npz`` the JAX package writes for a group-norm system loads
  strictly into the port and gives JAX's mask; the port's variables, back
  through the bridge, give it in JAX.
- ``--norm group`` on the port's command line, a JAX config's JSON
  carrying it, and ``Config.from_json`` refusing a key it does not know.
- A group-norm Trainer run stopped and resumed is the unstopped run, bit
  for bit (no pending statistics to carry).
"""

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train_step import B, G, _flat, cgnet_grads_f64, replay_draws
from test_torch_train_step import CFG as BN_CFG

from crnerf_tpu.config import Config
from crnerf_tpu.config import get_config as jax_get_config
from crnerf_tpu.data.pipeline import TrainPipeline as JaxPipeline
from crnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from crnerf_tpu.models import cgnet as jax_cgnet
from crnerf_tpu.render.system import CrNerfSystem as JaxSystem
from crnerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from crnerf_tpu.train.state import TrainState as JaxTrainState
from crnerf_tpu.train.step import make_train_step as jax_make_train_step
from crnerf_tpu.utils.checkpoint import save_weights_only
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.config import FIELD_NO_COUNTERPART, get_config
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.models.cgnet import ContextGuidedNetwork
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import make_train_step
from crnerf_tpu_torch.utils import weights as bridge
from crnerf_tpu_torch.utils.logging import MetricLogger

CFG = BN_CFG.replace(norm="group")
TCFG = PortConfig(**{f.name: getattr(CFG, f.name)
                     for f in dataclasses.fields(PortConfig)})
N_STEPS = 2
HW = (48, 64)
# the training step's bounds, tests/test_torch_train_step.py's: the first
# step's metrics, the second's (its parameters already differ by Adam's
# rounding noise), a leaf's gradient and a CGNet leaf's (the JAX side's
# fp32 noise; the port's is held to float64 at 5e-4)
METRIC_RTOL = (1e-4, 1e-3)
GRAD_TOL, CGNET_GRAD_TOL, CGNET_F64_TOL = 2e-3, 5e-2, 5e-4


def _images(seed, n=2):
    h, w = HW
    return np.random.default_rng(seed).uniform(
        0, 1, (n, h, w, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def cgnet_vars():
    net = jax_cgnet.ContextGuidedNetwork(classes=1, M=2, N=2,
                                         input_channel=3, norm="group")
    x = _images(0)
    v = jax.jit(lambda k: net.init(k, x[:1], train=False))(
        jax.random.PRNGKey(3))
    return net, jax.tree.map(np.asarray, v)


@pytest.mark.parametrize("train", [True, False])
def test_cgnet_forward_matches_jax(cgnet_vars, train):
    """GroupNorm has no running statistics: training and eval mode are one
    function, here on two images whose statistics differ."""
    net, v = cgnet_vars
    assert v.get("batch_stats", {}) == {}
    assert "GroupNorm_0" in v["params"]["level1_0"]["_Norm_0"]
    x = _images(1)
    x[1] = 0.5 * x[1] + 0.3
    want = np.asarray(jax.jit(functools.partial(net.apply, train=train))(
        v, x))
    port = bridge.load_into(ContextGuidedNetwork(norm="group"), v)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, *HW, 1)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    assert port.norms() == []
    assert {m.GroupNorm_0.num_groups for m in port.modules()
            if type(m).__name__ == "_Norm"} == {8, 1}


def test_a_norm_the_jax_package_does_not_name_is_refused():
    with pytest.raises(ValueError, match="layer"):
        CrNerfSystem(TCFG.replace(norm="layer"))
    with pytest.raises(ValueError, match="layer"):
        ContextGuidedNetwork(norm="layer")


# ------------------------------------------------------------- the step

@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages through N_STEPS group-norm steps, then the JAX state's
    weights.npz."""
    scene = jax_scene(n_train=4, n_test=1, img_wh=(24, 18),
                      appearance_wh=CFG.appearance_wh)
    pipe = JaxPipeline(scene, batch_size=B)
    batches = [pipe.make_global_batch(0, i, G) for i in range(N_STEPS)]
    jsys = JaxSystem(CFG)
    variables = jax.jit(jsys.init)(jax.random.PRNGKey(0))
    tx, sched = jax_make_optimizer(CFG, pipe.iterations)
    jstate = JaxTrainState.create(
        variables, tx.init(variables["params"]), n_vocab=CFG.N_vocab,
        embed_hw=32, embed_c=CFG.nerf_out_dim, rng=jax.random.PRNGKey(1))
    jstep = jax.jit(jax_make_train_step(jsys, tx, sched, grids_per_step=G,
                                        grad_accum_chunks=1))
    system = bridge.load_into(CrNerfSystem(TCFG),
                              jax.tree.map(np.asarray, variables))
    opt, psched = make_optimizer(TCFG, pipe.iterations, system.parameters())
    pstate = TrainState.create(system, opt, TCFG.N_vocab, 32,
                               TCFG.nerf_out_dim)
    pstep = make_train_step(system, opt, psched, G, 1)
    cgnet_io = {}

    def capture(_, inputs, out):
        def keep(g):
            cgnet_io["cot"] = g.numpy().copy()

        cgnet_io["x"] = inputs[0].detach().numpy().copy()
        out.register_hook(keep)

    hook = system.implicit_mask.register_forward_hook(capture)
    steps = []
    for b in batches:
        draws = replay_draws(jstate.rng, jstate.embedding_valid)
        before = _flat(jstate.params)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()
                                    if k != "image_idx"})
        tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        pstate, pm = pstep(pstate, tb, draws)
        hook.remove()
        port_vars = bridge.flax_from_state_dict(system)
        steps.append(dict(
            jax_before=before, jax_params=_flat(jstate.params),
            jax_stats=jax.tree.map(np.asarray, jstate.batch_stats),
            jax_mu=_flat(jstate.opt_state[0].mu),
            jax_cache=np.asarray(jstate.embedding_cache),
            jax_metrics={k: float(v) for k, v in jm.items()},
            port_params=bridge.flatten(port_vars["params"]),
            port_stats=port_vars["batch_stats"],
            port_grads=bridge.flatten(bridge.flax_from_state_dict(
                system, grads=True)["params"]),
            port_cache=pstate.embedding_cache.numpy().copy(),
            port_metrics={k: float(v) for k, v in pm.items()}))
    npz = str(tmp_path_factory.mktemp("gn") / "weights.npz")
    save_weights_only(jstate, npz)
    cgnet_vars = {k: jax.tree.map(np.asarray, variables[k]["implicit_mask"])
                  for k in ("params", "batch_stats")}
    return dict(steps=steps, lr=float(sched(0)), npz=npz, jsys=jsys,
                jstate=jstate, system=system,
                cgnet_f64=cgnet_grads_f64(cgnet_vars, cgnet_io, "group"))


@pytest.mark.parametrize("i", range(N_STEPS))
def test_step_metrics_match(run, i):
    jm = run["steps"][i]["jax_metrics"]
    pm = run["steps"][i]["port_metrics"]
    assert set(jm) == set(pm)
    rtol = METRIC_RTOL[i]
    for k in jm:
        tol = dict(rtol=rtol, atol=10 * rtol) if k == "psnr" else dict(
            rtol=rtol, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)


def _jax_grads(step):
    return {k: v / 0.1 for k, v in step["jax_mu"].items()}


def test_step_per_leaf_gradients_match(run):
    """Step 1, per leaf: GRAD_TOL of the leaf's largest gradient; CGNet's
    GroupNorm leaves among them."""
    step = run["steps"][0]
    jg, pg = _jax_grads(step), step["port_grads"]
    assert set(jg) == set(pg)
    assert sum(".GroupNorm_0." in k for k in jg) == 2 * 14
    for k in jg:
        scale = np.abs(jg[k]).max()
        rel = CGNET_GRAD_TOL if k.startswith("implicit_mask.") else GRAD_TOL
        np.testing.assert_allclose(pg[k], jg[k], atol=rel * scale + 1e-7,
                                   err_msg=k)
    assert all(np.abs(pg[k]).max() > 0 for k in pg if ".GroupNorm_0." in k)


def test_step_cgnet_gradients_at_float64(run):
    """On step 1's own mask cotangent, at float64, the packages' group-norm
    CGNet gradients are one function (1e-9 of a leaf's largest), and the
    port's fp32 step gradients lie within CGNET_F64_TOL of it."""
    want, got = run["cgnet_f64"]
    assert set(want) == set(got) and len(want) > 50
    worst = lambda a, b: max(np.abs(a[k] - b[k]).max()    # noqa: E731
                             / np.abs(b[k]).max() for k in b)
    assert worst(got, want) <= 1e-9
    pre = "implicit_mask."
    port32 = {k[len(pre):]: v for k, v in run["steps"][0]["port_grads"]
              .items() if k.startswith(pre)}
    assert set(port32) == set(want)
    assert worst(port32, want) <= CGNET_F64_TOL


@pytest.mark.parametrize("i", range(N_STEPS))
def test_step_parameter_deltas_and_cache_match(run, i):
    """tests/test_torch_train_step.py's delta rule: every element within 2
    lr, those whose step-1 gradient exceeds 1e-5 within 2 % of lr (CGNet's
    within 2 % of lr of Adam's update from the float64 gradient, step 1);
    the cache rows 1e-5. Neither side keeps statistics."""
    step, lr = run["steps"][i], run["lr"]
    g0 = _jax_grads(run["steps"][0])
    n_checked = 0
    for k, new in step["jax_params"].items():
        before = (step["jax_before"][k] if i == 0
                  else run["steps"][i - 1]["port_params"][k])
        d_j = new - step["jax_before"][k]
        d_p = step["port_params"][k] - before
        assert np.abs(d_p - d_j).max() <= 2 * lr + 1e-9, k
        if k.startswith("implicit_mask."):
            if i == 0:
                g64 = run["cgnet_f64"][0][k[len("implicit_mask."):]]
                big = np.abs(g64) > 1e-6
                want = -lr * g64 / (np.abs(g64) + 1e-8)
                np.testing.assert_allclose(d_p[big], want[big],
                                           atol=0.02 * lr, err_msg=k)
            continue
        big = np.abs(g0[k]) > 1e-5
        n_checked += int(big.sum())
        np.testing.assert_allclose(d_p[big], d_j[big], atol=0.02 * lr,
                                   err_msg=k)
    assert n_checked > 10000
    np.testing.assert_allclose(step["port_cache"], step["jax_cache"],
                               atol=1e-5)
    assert step["jax_stats"] == {"implicit_mask": {}}
    assert step["port_stats"] == {"implicit_mask": {}}


# ------------------------------------------------------ the weight bridge

def test_jax_weights_npz_loads_strictly_and_gives_jax_mask(run):
    """The JAX state's weights.npz (no batch_stats leaf at all) into the
    port's system, strictly; CGNet's mask on a style image against JAX's
    eval mask, 1e-5; the port's variables back in JAX give it too."""
    with np.load(run["npz"]) as f:
        keys = set(f.files)
    assert not any(k.startswith("batch_stats.") for k in keys)
    assert "params.implicit_mask.b1._Norm_0.GroupNorm_0.scale" in keys
    port = bridge.load_into(CrNerfSystem(TCFG), run["npz"]).eval()
    assert port.state_dict().keys() == run["system"].state_dict().keys()
    whole = _images(2, 1)[:, :48, :64]
    jsys, jstate = run["jsys"], run["jstate"]
    mask = jax.jit(lambda v, x: jsys.predict_mask(v, x, train=False))
    want, new_stats = mask({"params": jstate.params,
                            "batch_stats": jstate.batch_stats}, whole)
    want = np.asarray(want)
    assert new_stats is None
    with torch.no_grad():
        got = port.predict_mask(torch.from_numpy(whole)).numpy()
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol)
    back = bridge.flax_from_state_dict(port)
    assert back["batch_stats"] == {"implicit_mask": {}}
    again, _ = mask(back, whole)
    np.testing.assert_allclose(np.asarray(again), want, atol=tol)
    with pytest.raises(RuntimeError, match="GroupNorm_0"):
        bridge.load_into(CrNerfSystem(TCFG.replace(norm="batch")),
                         run["npz"])


# ------------------------------------------------------------ the config

def test_norm_group_on_the_command_line_and_in_a_jax_json():
    argv = ["--norm", "group", "--batch_size", "256", "--no-use_residual",
            "--N_a", "32", "--decoder", "other", "--refresh_every", "3",
            "--decoder_num_res_blocks", "2", "--sigma_dropout_rate", "0.1"]
    cfg, jcfg = get_config(argv), jax_get_config(argv)
    assert cfg.norm == "group"
    for f in dataclasses.fields(PortConfig):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert PortConfig.from_json(jcfg.to_json()) == cfg
    assert PortConfig.from_json(cfg.to_json()) == cfg
    jcfg2 = Config(norm="group", pallas_interpret=True, mesh_shape=(2, 1),
                   eval_bucket=False)
    assert PortConfig.from_json(jcfg2.to_json()) == PortConfig(norm="group")


def test_from_json_refuses_a_key_it_does_not_know():
    d = json.loads(PortConfig(norm="group").to_json())
    d["nrom"] = "group"
    with pytest.raises(ValueError, match="nrom"):
        PortConfig.from_json(json.dumps(d))
    d = json.loads(Config().to_json())
    assert set(d) - {f.name for f in dataclasses.fields(PortConfig)} == set(
        FIELD_NO_COUNTERPART)


# ---------------------------------------------------- the Trainer's resume

TRAIN_CFG = PortConfig(batch_size=64, grids_per_step=2, N_samples=4,
                       N_importance=4, netdepth=2, netwidth=16,
                       nerf_out_dim=8, N_emb_xyz=10, N_vocab=10,
                       appearance_wh=(64, 48), num_epochs=1, val_chunk=256,
                       chunk=256, log_every=3, img_panel_every=2,
                       norm="group")
STOP_AT = 5


def _full_state(tr):
    st = tr.state
    out = {f"system.{k}": v.clone() for k, v in st.system.state_dict().items()}
    for i, s in st.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = torch.as_tensor(v).clone()
    out["cache"] = st.embedding_cache.clone()
    out["generator"] = st.generator.get_state()
    return out


def test_group_norm_trainer_resumes_to_the_unstopped_bits(tmp_path):
    """With panels (a training-mode forward outside the step) every 2
    steps; the state holds no running statistics."""
    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=(24, 18),
                                 appearance_wh=TRAIN_CFG.appearance_wh)
    cfg = TRAIN_CFG.replace(save_dir=str(tmp_path))

    def logger(exp):
        return MetricLogger(str(tmp_path / "logs"), exp)

    whole = Trainer(cfg.replace(exp_name="whole"), scene, logger("whole"),
                    device="cpu")
    whole.fit()
    stopped = Trainer(cfg.replace(exp_name="stopped"), scene,
                      logger("stopped"), device="cpu")
    step_fn = stopped.step_fn

    def stop_after(state, batch, draws=None):
        out = step_fn(state, batch, draws)
        if state.step == STOP_AT:
            stopped.request_stop()
        return out

    stopped.step_fn = stop_after
    stopped.fit()
    assert stopped.ckpt.all_steps() == [STOP_AT]
    resumed = Trainer(cfg.replace(exp_name="stopped", auto_resume=True),
                      scene, logger("resumed"), device="cpu")
    resumed.fit()
    a, b = _full_state(resumed), _full_state(whole)
    assert a.keys() == b.keys()
    assert not any("running_" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert os.path.exists(os.path.join(whole.ckpt.directory, "weights.npz"))
    assert os.listdir(tmp_path / "logs" / "whole" / "images")
