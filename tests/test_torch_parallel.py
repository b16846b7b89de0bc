"""The port's data parallelism (``crnerf_tpu_torch/parallel/mesh.py``) on
the CPU: two gloo ranks, spawned with torch.multiprocessing, against the
JAX package's two-device ``shard_train_step`` / ``shard_render`` on the
virtual CPU mesh and against one port process with both ranks' grids.

- One step of 2 ranks x G = 2 from the same weights (the bridge), the same
  global batch and JAX's per-device draws (``fold_in(key, d)``, replayed):
  loss, psnr, Adam's first moment (0.1 g), the parameter deltas, CGNet's
  running statistics and the cache, within the bounds that
  tests/test_torch_train_step.py holds one step to; the two replicas equal
  bit for bit.
- The same step in one process at G = 4: the bounds of that file's
  chunked-against-unchunked test (the same mean, summed in another order);
  and with CGNet's GroupNorm (``norm="group"``: no statistics in the
  all-reduce), two ranks against one process under the same bounds.
- Each rank's batch stream against ``epoch_batches(epoch, 2,
  grids_per_device=2)``, array for array.
- The sharded eval render against JAX's ``shard_render`` and, bit for bit,
  against the port's single-process ``forward_eval``; on a frame smaller
  than the style image on both axes, its mask against JAX's ``Renderer``
  (JAX's ``shard_render`` antialiases the mask there, a reference quirk).
- The train CLI on two ranks: SIGTERM to rank 1 alone stops both after one
  step with one checkpoint, and ``--auto_resume`` ends on the unstopped
  two-rank run's bits; a one-process resume of a two-rank checkpoint
  restores it exactly and trains on.
- The launch rules: ``num_devices`` against a launcher's ``WORLD_SIZE``,
  and ``--num_devices 2 --device cuda`` refused without a card.

Widths are small (2 layers x 16, as tests/test_apps.py's CLI run), fp32.
oneDNN is off in the port's steps here, as in test_torch_train_step.py's
chunked test: its backward for a batch of one image is far from the
float64 gradient in CGNet's first layers.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnerf_tpu.config import Config
from crnerf_tpu.data.pipeline import TrainPipeline as JaxPipeline
from crnerf_tpu.data.synthetic import make_synthetic_scene as jax_scene
from crnerf_tpu.parallel.mesh import (
    make_mesh,
    put_global_batch,
    put_replicated,
    shard_render,
    shard_train_step,
)
from crnerf_tpu.render.inference import Renderer as JaxRenderer
from crnerf_tpu.render.system import CrNerfSystem as JaxSystem
from crnerf_tpu.train.optim import make_optimizer as jax_make_optimizer
from crnerf_tpu.train.state import TrainState as JaxTrainState
from crnerf_tpu.train.step import make_train_step as jax_make_train_step
from crnerf_tpu_torch import Config as PortConfig
from crnerf_tpu_torch.config import get_config
from crnerf_tpu_torch.core.rays import cam_rays_uv
from crnerf_tpu_torch.data.pipeline import TrainPipeline
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.parallel import mesh
from crnerf_tpu_torch.render.system import CrNerfSystem
from crnerf_tpu_torch.train.optim import make_optimizer
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.train.state import TrainState
from crnerf_tpu_torch.train.step import make_train_step, reduce_metrics
from crnerf_tpu_torch.utils import weights as bridge
from crnerf_tpu_torch.utils.checkpoint import state_payload

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, G, B = 2, 2, 64
CFG = Config(
    batch_size=B, grids_per_step=G, N_samples=8, N_importance=8, netdepth=2,
    netwidth=16, nerf_out_dim=8, N_emb_xyz=10, N_vocab=8,
    appearance_wh=(64, 48), compute_dtype="float32", pallas_interpret=True,
    num_epochs=2, chunk=128,
)
TCFG = PortConfig(**{f.name: getattr(CFG, f.name)
                     for f in dataclasses.fields(PortConfig)})
# the eval render: 51 x 67 pixels, not a multiple of D (the last rank
# pads), above the style image's 48 x 64 on both axes: JAX's
# forward_eval_sharded resizes CGNet's mask to the frame with
# jax.image.resize, which antialiases when it shrinks; its Renderer and the
# port sample the mask at pixel centres, the same where it grows
EVAL_HW = (51, 67)
# and 23 x 29, below it on both axes (again not a multiple of D): the
# shrinking side of the mask's resize
SMALL_HW = (23, 29)
EVAL_CFG = CFG.replace(noise_std=0.0, encode_random=False,
                       pallas_interpret=False)
C2W = np.array([[1, 0, 0, 0.1], [0, 1, 0, -0.05], [0, 0, 1, 1.5]],
               np.float32)
# rgb in [0, 1], depth ~1.5, the mask: tests/test_torch_slice.py's bounds
RGB_TOL, DEPTH_TOL, MASK_TOL = 5e-4, 1e-3, 1e-5
RANK_ENV = {"OMP_NUM_THREADS": "2"}


def _flat(tree):
    return bridge.flatten(jax.tree.map(np.asarray, tree))


def device_draws(rng, valid, d):
    """What device ``d`` of the JAX step draws from ``rng`` with the cache
    validity ``valid`` (its keys folded with d), as the port's ``draws``
    (tests/test_torch_train_step.py ``replay_draws``)."""
    _, kstep, ksel = jax.random.split(rng, 3)
    kstep, ksel = jax.random.fold_in(kstep, d), jax.random.fold_in(ksel, d)
    n = valid.shape[0]
    idx = [int(jnp.argmax(jnp.where(valid, jax.random.gumbel(k, (n,)),
                                    -jnp.inf)))
           for k in jax.random.split(ksel, G)]
    s, i = CFG.N_samples, CFG.N_importance
    per = {"z_u": [], "noise_coarse": [], "noise_fine": [], "pdf_e": []}
    for key in jax.random.split(kstep, G):
        (kf,) = jax.random.split(key, 1)
        kz, kn_c, kn_f, kpdf, _, _ = jax.random.split(kf, 6)
        per["z_u"].append(jax.random.uniform(kz, (B, s), jnp.float32))
        per["noise_coarse"].append(
            CFG.noise_std * jax.random.normal(kn_c, (B, s), jnp.float32))
        per["noise_fine"].append(
            CFG.noise_std * jax.random.normal(kn_f, (B, s + i), jnp.float32))
        per["pdf_e"].append(
            jax.random.exponential(kpdf, (B, i + 1), dtype=jnp.float32))
    draws = {k: torch.from_numpy(np.stack([np.asarray(a) for a in v]))
             for k, v in per.items()}
    draws["sel_idx"] = torch.tensor(idx, dtype=torch.int64)
    return draws


def port_state(sd, cfg=TCFG):
    """A port TrainState of ``cfg`` whose system holds the state dict
    ``sd``."""
    system = CrNerfSystem(cfg)
    system.load_state_dict(sd)
    opt, sched = make_optimizer(cfg, 10, system.parameters())
    return TrainState.create(system, opt, cfg.N_vocab, 32,
                             cfg.nerf_out_dim), sched


def state_out(state, metrics):
    """What the comparisons read of a state after a step."""
    v = bridge.flax_from_state_dict(state.system)
    mu = {}
    for p, name in zip(state.system.parameters(),
                       dict(state.system.named_parameters())):
        mu[name] = state.optimizer.state[p]["exp_avg"].clone()
    return dict(params=bridge.flatten(v["params"]),
                stats=bridge.flatten(v["batch_stats"]),
                sd={k: t.clone() for k, t in
                    state.system.state_dict().items()},
                mu=mu, cache=state.embedding_cache.clone(),
                valid=state.embedding_valid.clone(), metrics=metrics)


def rank_job(path):
    """One rank of the step and, where the job has one, the sharded render
    (run by mesh.spawn)."""
    _, group = mesh.init_distributed("cpu")
    r = mesh.rank(group)
    job = torch.load(path, weights_only=False)
    state, sched = port_state(job["sd"], job.get("cfg", TCFG))
    step = make_train_step(state.system, state.optimizer, sched, G, 1,
                           group=group)
    with torch.backends.mkldnn.flags(enabled=False):
        state, m = step(state, job["batches"][r], job["draws"][r])
    out = state_out(state, reduce_metrics(m, group))
    if "eval" in job:     # and the sharded render
        system = state.system.eval()
        system.load_state_dict(job["eval_sd"])
        for key, hw in (("render", EVAL_HW), ("render_small", SMALL_HW)):
            ev = job["eval"][hw]
            out[key] = system.forward_eval_sharded(
                ev["rays"], ev["uv"], ev["whole"], hw,
                system.kernel_weights(), group, tile=ev["tile"])
    torch.save(out, path + f".rank{r}")
    torch.distributed.destroy_process_group()


def _spawn_ranks(path):
    """rank_job on D spawned ranks -> each rank's output."""
    saved = {k: os.environ.get(k) for k in RANK_ENV}
    os.environ.update(RANK_ENV)
    try:
        mesh.spawn(rank_job, D, (path,), timeout=300)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return [torch.load(path + f".rank{r}", weights_only=False)
            for r in range(D)]


def eval_inputs(hw=EVAL_HW):
    h, w = hw
    intr = torch.tensor([60.0, 60.0, w / 2, h / 2])
    rays, uv = cam_rays_uv(torch.from_numpy(C2W), intr, 0.5, 2.5, (h, w))
    wa, ha = CFG.appearance_wh
    whole = np.random.default_rng(3).uniform(-1, 1, (1, ha, wa, 3))
    return dict(rays=rays, uv=uv, tile=256,
                whole=torch.from_numpy(whole.astype(np.float32)))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One step on the JAX mesh, on two port ranks and in one port process
    at G = 4; the sharded render on the JAX mesh and on the two ranks."""
    scene = jax_scene(n_train=4, n_test=1, img_wh=(24, 18),
                      appearance_wh=CFG.appearance_wh)
    pipe = JaxPipeline(scene, batch_size=B)
    glob = pipe.make_global_batch(0, 0, D * G)
    glob = {k: v for k, v in glob.items() if k != "image_idx"}
    jsys = JaxSystem(CFG)
    variables = jsys.init(jax.random.PRNGKey(0))
    tx, sched = jax_make_optimizer(CFG, 10)
    jstate = JaxTrainState.create(
        variables, tx.init(variables["params"]), n_vocab=CFG.N_vocab,
        embed_hw=32, embed_c=CFG.nerf_out_dim, rng=jax.random.PRNGKey(1))
    draws = [device_draws(jstate.rng, jstate.embedding_valid, d)
             for d in range(D)]
    m2 = make_mesh(D)
    jstep = shard_train_step(
        jax_make_train_step(jsys, tx, sched, axis_name="data",
                            grids_per_step=G), m2, donate_state=False)
    dev_batch = {k: v.reshape(D, G, *v.shape[1:]) for k, v in glob.items()}
    jnew, jm = jstep(put_replicated(jstate, m2),
                     put_global_batch(dev_batch, m2))

    port_sys = bridge.load_into(CrNerfSystem(TCFG),
                                jax.tree.map(np.asarray, variables))
    sd = {k: v.clone() for k, v in port_sys.state_dict().items()}
    tglob = {k: torch.from_numpy(np.asarray(v)) for k, v in glob.items()}
    batches = [{k: v[r * G:(r + 1) * G] for k, v in tglob.items()}
               for r in range(D)]

    # the eval render's weights and inputs
    evars = JaxSystem(EVAL_CFG).init(jax.random.PRNGKey(5))
    eval_sys = bridge.load_into(CrNerfSystem(dataclasses.replace(
        TCFG, noise_std=0.0, encode_random=False)),
        jax.tree.map(np.asarray, evars)).eval()
    evs = {hw: eval_inputs(hw) for hw in (EVAL_HW, SMALL_HW)}
    jrender, single_render = {}, {}
    for hw, ev in evs.items():
        jrender[hw] = {k: np.asarray(v) for k, v in shard_render(
            JaxSystem(EVAL_CFG), m2, hw)(
                evars, ev["rays"].numpy(), ev["whole"].numpy(),
                jax.random.PRNGKey(0)).items()}
        single_render[hw] = eval_sys.forward_eval(
            ev["rays"], ev["uv"], ev["whole"], hw,
            eval_sys.kernel_weights(), tile=ev["tile"])
    ev = evs[SMALL_HW]
    jax_renderer_small = JaxRenderer(EVAL_CFG, evars).render_frame(
        ev["rays"].numpy(), ev["whole"].numpy(), SMALL_HW)

    path = str(tmp_path_factory.mktemp("ranks") / "job.pt")
    torch.save(dict(sd=sd, batches=batches, draws=draws, eval=evs,
                    eval_sd=eval_sys.state_dict()), path)
    ranks = _spawn_ranks(path)

    # one process, both ranks' grids: a step of G = 4 on the global batch
    state, psched = port_state(sd)
    one_step = make_train_step(state.system, state.optimizer, psched, D * G)
    both = {k: torch.cat([d[k] for d in draws], 0) for k in draws[0]}
    with torch.backends.mkldnn.flags(enabled=False):
        state, m = one_step(state, tglob, both)
    single = state_out(state, reduce_metrics(m, None))
    return dict(
        ranks=ranks, single=single, lr=float(sched(0)),
        jax_before=_flat(jstate.params), jax_params=_flat(jnew.params),
        jax_stats=_flat(jnew.batch_stats),
        jax_mu=_flat(jnew.opt_state[0].mu),
        jax_cache=np.asarray(jnew.embedding_cache),
        jax_valid=np.asarray(jnew.embedding_valid),
        jax_metrics={k: float(v) for k, v in jm.items()},
        ts=glob["ts"][:, 0],
        jax_render=jrender[EVAL_HW], single_render=single_render[EVAL_HW],
        jax_render_small=jrender[SMALL_HW],
        single_render_small=single_render[SMALL_HW],
        jax_renderer_small=jax_renderer_small)


def _port_mu(out, cfg=TCFG):
    """Adam's first moment by the flax leaf names (the bridge's)."""
    system = CrNerfSystem(cfg)
    with torch.no_grad():
        for p, name in zip(system.parameters(),
                           dict(system.named_parameters())):
            p.grad = out["mu"][name]
    return bridge.flatten(bridge.flax_from_state_dict(
        system, grads=True)["params"])


def test_replicas_are_bit_identical(run):
    a, b = run["ranks"]
    for k in a["sd"]:
        assert torch.equal(a["sd"][k], b["sd"][k]), k
    for k in a["mu"]:
        assert torch.equal(a["mu"][k], b["mu"][k]), k
    assert torch.equal(a["cache"], b["cache"])
    assert torch.equal(a["valid"], b["valid"])
    assert a["metrics"] == b["metrics"]


def test_step_metrics_match_the_jax_mesh_step(run):
    """loss, psnr and every term: 1e-4 relative + 1e-7 (psnr 1e-3 dB), the
    bounds of test_torch_train_step.py's first step, on the mean over
    the ranks against JAX's pmean."""
    jm, pm = run["jax_metrics"], run["ranks"][0]["metrics"]
    assert set(jm) == set(pm)
    for k in jm:
        tol = dict(rtol=1e-4, atol=1e-3) if k == "psnr" else dict(
            rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(pm[k], jm[k], err_msg=k, **tol)


def test_gradients_and_deltas_match_the_jax_mesh_step(run):
    """Adam's first moment after one step is 0.1 g: per leaf within 2e-3
    of the leaf's largest + 1e-7 (CGNet 5e-2, the JAX side's fp32 CGNet,
    see test_torch_train_step.py). Parameter deltas: every element within
    2 lr; elements whose gradient exceeds 1e-5 within 2% of lr (CGNet's
    leaves are held there to a float64 gradient; here only to 2 lr)."""
    jg = {k: v / 0.1 for k, v in run["jax_mu"].items()}
    pg = {k: v / 0.1 for k, v in _port_mu(run["ranks"][0]).items()}
    assert set(jg) == set(pg)
    for k in jg:
        rel = 5e-2 if k.startswith("implicit_mask.") else 2e-3
        np.testing.assert_allclose(pg[k], jg[k], err_msg=k,
                                   atol=rel * np.abs(jg[k]).max() + 1e-7)
    lr, n_checked = run["lr"], 0
    port = run["ranks"][0]["params"]
    for k, new in run["jax_params"].items():
        before = run["jax_before"][k]
        d_j, d_p = new - before, port[k] - before
        assert np.abs(d_p - d_j).max() <= 2 * lr + 1e-9, k
        if k.startswith("implicit_mask."):
            continue
        big = np.abs(jg[k]) > 1e-5
        n_checked += int(big.sum())
        if big.any():
            np.testing.assert_allclose(d_p[big], d_j[big], atol=0.02 * lr,
                                       err_msg=k)
    assert n_checked > 1000


def test_stats_and_cache_match_the_jax_mesh_step(run):
    """CGNet's running statistics 1e-5; the cache rows 1e-5 and its
    validity equal, the rows of all D G grids written on every replica."""
    out = run["ranks"][0]
    for k, v in run["jax_stats"].items():
        np.testing.assert_allclose(out["stats"][k], v, atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(out["valid"].numpy(), run["jax_valid"])
    assert out["valid"].numpy()[run["ts"]].all()
    np.testing.assert_allclose(out["cache"].numpy(), run["jax_cache"],
                               atol=1e-5)


def test_two_ranks_match_one_process_with_their_grids(run):
    """The same mean summed in another order (test_torch_train_step.py's
    chunked test): first moments 1e-4 of the leaf's largest + 1e-9 (CGNet
    5e-4), metrics 1e-6 relative, statistics and cache 1e-6."""
    out, one = run["ranks"][0], run["single"]
    a, b = _port_mu(out), _port_mu(one)
    for k in b:
        rel = 5e-4 if k.startswith("implicit_mask.") else 1e-4
        np.testing.assert_allclose(a[k], b[k], err_msg=k,
                                   atol=rel * np.abs(b[k]).max() + 1e-9)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-6,
                                   err_msg=k)
    for k, v in one["stats"].items():
        np.testing.assert_allclose(out["stats"][k], v, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(out["cache"].numpy(), one["cache"].numpy(),
                               atol=1e-6)
    assert torch.equal(out["valid"], one["valid"])


GN_CFG = dataclasses.replace(TCFG, norm="group")


@pytest.fixture(scope="module")
def group_norm_run(tmp_path_factory):
    """One step with norm="group" on two ranks and in one process at
    G = 4, from the port's seeded weights, on the port's batch and seeded
    draws (each grid's random embedding row named: the cache is empty)."""
    scene = make_synthetic_scene(n_train=4, n_test=1, img_wh=(24, 18),
                                 appearance_wh=GN_CFG.appearance_wh)
    glob = TrainPipeline(scene, batch_size=B).make_global_batch(0, 0, D * G)
    tglob = {k: torch.from_numpy(v) for k, v in glob.items()
             if k != "image_idx"}
    torch.manual_seed(7)
    sd = CrNerfSystem(GN_CFG).state_dict()
    gen = torch.Generator().manual_seed(8)
    s, i, n = GN_CFG.N_samples, GN_CFG.N_importance, D * G
    both = {"z_u": torch.rand(n, B, s, generator=gen),
            "noise_coarse": torch.randn(n, B, s, generator=gen),
            "noise_fine": torch.randn(n, B, s + i, generator=gen),
            "pdf_e": torch.empty(n, B, i + 1).exponential_(generator=gen),
            "sel_idx": torch.zeros(n, dtype=torch.int64)}
    cut = lambda d, r: {k: v[r * G:(r + 1) * G]   # noqa: E731
                        for k, v in d.items()}
    path = str(tmp_path_factory.mktemp("gn_ranks") / "job.pt")
    torch.save(dict(sd=sd, cfg=GN_CFG,
                    batches=[cut(tglob, r) for r in range(D)],
                    draws=[cut(both, r) for r in range(D)]), path)
    ranks = _spawn_ranks(path)
    state, sched = port_state(sd, GN_CFG)
    one_step = make_train_step(state.system, state.optimizer, sched, D * G)
    with torch.backends.mkldnn.flags(enabled=False):
        state, m = one_step(state, tglob, both)
    return dict(ranks=ranks, single=state_out(state, reduce_metrics(m, None)))


def test_two_ranks_match_one_process_with_group_norm(group_norm_run):
    """test_two_ranks_match_one_process_with_their_grids's bounds; the
    replicas the same bits; no statistics on either side."""
    out, one = group_norm_run["ranks"][0], group_norm_run["single"]
    for k in out["sd"]:
        assert torch.equal(out["sd"][k], group_norm_run["ranks"][1]["sd"][k])
    assert not any("running_" in k for k in one["sd"])
    assert out["stats"] == one["stats"] == {}
    a, b = _port_mu(out, GN_CFG), _port_mu(one, GN_CFG)
    assert sum(".GroupNorm_0." in k for k in b) == 28
    for k in b:
        rel = 5e-4 if k.startswith("implicit_mask.") else 1e-4
        np.testing.assert_allclose(a[k], b[k], err_msg=k,
                                   atol=rel * np.abs(b[k]).max() + 1e-9)
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(out["metrics"][k], v, rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(out["cache"].numpy(), one["cache"].numpy(),
                               atol=1e-6)
    assert torch.equal(out["valid"], one["valid"])


def test_sharded_render_is_the_single_process_render(run):
    """Every rank's whole frame has the bits of forward_eval."""
    want = run["single_render"]
    for out in run["ranks"]:
        got = out["render"]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_sharded_render_matches_the_jax_mesh_render(run):
    got, want = run["ranks"][1]["render"], run["jax_render"]
    for k, tol in (("rgb_fine", RGB_TOL), ("rgb_coarse", RGB_TOL),
                   ("depth_coarse", DEPTH_TOL), ("depth_fine", DEPTH_TOL),
                   ("out_mask", MASK_TOL)):
        np.testing.assert_allclose(got[k].numpy().reshape(want[k].shape),
                                   want[k], atol=tol, err_msg=k)


def test_small_frame_sharded_render_is_the_single_process_render(run):
    """A frame below the style image on both axes: every rank's whole
    frame has the bits of forward_eval there too."""
    want = run["single_render_small"]
    assert want["out_mask"].shape == (SMALL_HW[0] * SMALL_HW[1], 1)
    for out in run["ranks"]:
        got = out["render_small"]
        assert set(got) == set(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_small_frame_mask_matches_the_jax_renderer(run):
    """There the port's sharded mask (CGNet's map sampled at pixel
    centres) holds to JAX's Renderer's within MASK_TOL, as its rgb and
    depth hold to JAX's shard_render."""
    got = run["ranks"][0]["render_small"]
    want = run["jax_renderer_small"]
    np.testing.assert_allclose(got["out_mask"].numpy().reshape(SMALL_HW),
                               want["mask"], atol=MASK_TOL)
    jr = run["jax_render_small"]
    for k, tol in (("rgb_fine", RGB_TOL), ("depth_fine", DEPTH_TOL)):
        np.testing.assert_allclose(got[k].numpy().reshape(jr[k].shape),
                                   jr[k], atol=tol, err_msg=k)


def test_jax_shard_render_antialiases_the_small_mask(run):
    """A reference quirk, recorded: JAX's shard_render resizes CGNet's
    mask with jax.image.resize, which antialiases when it shrinks, so on
    this frame its mask leaves its own Renderer's (and the port's) by more
    than MASK_TOL (measured 9.87e-5 on these random weights, whose mask is
    smooth); on the larger EVAL_HW frame the port holds to it within
    MASK_TOL (test_sharded_render_matches_the_jax_mesh_render)."""
    jax_sharded = run["jax_render_small"]["out_mask"].reshape(SMALL_HW)
    diff = np.abs(jax_sharded - run["jax_renderer_small"]["mask"]).max()
    assert diff > MASK_TOL


@pytest.mark.parametrize("epoch", [0, 1])
def test_rank_batch_stream_is_the_jax_device_stream(epoch):
    """Rank r's batch of step i is row r of the JAX global batch of D G
    grids reshaped to (D, G, ...)."""
    kw = dict(n_train=3, n_test=0, img_wh=(24, 18), appearance_wh=(32, 24))
    jpipe, pipe = JaxPipeline(jax_scene(**kw), batch_size=16), \
        TrainPipeline(make_synthetic_scene(**kw), batch_size=16)
    want = list(jpipe.epoch_batches(epoch, D, grids_per_device=G))
    got = [list(pipe.epoch_batches(epoch, G, rank=r, world=D))
           for r in range(D)]
    assert len(want) == len(got[0]) == len(got[1]) > 1
    for i, w in enumerate(want):
        for r in range(D):
            assert set(got[r][i]) == set(w)
            for k in w:
                np.testing.assert_array_equal(got[r][i][k], w[k][r],
                                              err_msg=f"{k} step {i}")


# ------------------------------------------------------- the train CLI
# the synthetic scene's 6 images of 48 x 36: 40 steps an epoch of 2 ranks x 2
# grids of 64 rays
CLI = ["--dataset_name", "synthetic", "--batch_size", "64",
       "--grids_per_step", "2", "--N_samples", "4", "--N_importance", "4",
       "--netdepth", "2", "--netwidth", "16", "--nerf_out_dim", "8",
       "--N_vocab", "10", "--appearance_wh", "32", "24", "--chunk", "256",
       "--val_chunk", "256", "--num_epochs", "1", "--log_every", "1",
       "--device", "cpu"]
PREEMPT_AFTER = 3
# the wait for a two-rank CLI run's steps and exit: an unstopped run took
# 139 s where six copies of these tests ran beside a JAX-heavy test file
# on 8 cores (120 s killed it)
RUN_WAIT = 300


def _rank_procs(argv, d: int, logs: str):
    """``python -m crnerf_tpu_torch`` on d ranks as torchrun starts them
    (RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT), on a
    store that this process hosts as torchrun's agent does
    (``mesh.host_store``) -> (the ranks, the store to hold until they
    exit)."""
    store = mesh.host_store()
    procs = []
    for r in range(d):
        env = dict(os.environ, PYTHONPATH=REPO, **mesh.rank_env(store, r, d),
                   **RANK_ENV)
        f = open(os.path.join(logs, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "crnerf_tpu_torch", *argv], cwd=REPO,
            env=env, stdout=f, stderr=subprocess.STDOUT), f))
    return procs, store


def _finish(procs, logs: str, timeout: float = RUN_WAIT):
    out = []
    try:
        for r, (p, f) in enumerate(procs):
            rc = p.wait(timeout=timeout)
            f.close()
            with open(os.path.join(logs, f"rank{r}.log")) as g:
                out.append((rc, g.read()))
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    return out


def _rows(save, exp):
    path = os.path.join(save, "logs", exp, "metrics.jsonl")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(x) for x in f if x.endswith("\n")]


def _ckpt(save, exp, step):
    return torch.load(os.path.join(save, "ckpts", exp, f"{step}.pt"),
                      weights_only=False)


def _same_state(a, b, what: str = ""):
    """Two checkpoints hold the same bits; a failure names the first
    tensor that differs, after ``what``."""
    assert a["step"] == b["step"], (what, a["step"], b["step"])
    for k, v in a["system"].items():
        assert torch.equal(v, b["system"][k]), (what, k)
    for i, st in a["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(
                b["optimizer"]["state"][i][k])), (what, i, k)
    assert torch.equal(a["embedding_cache"], b["embedding_cache"]), \
        (what, "embedding_cache")
    assert torch.equal(a["embedding_valid"], b["embedding_valid"]), \
        (what, "embedding_valid")
    assert torch.equal(a["generator"], b["generator"]), (what, "generator")


def _tails(out, names, n: int = 3000) -> str:
    """The named runs' ranks' exit codes and the ends of their logs."""
    return "\n".join(f"--- {name} rank {r}: exit {rc}\n{text[-n:]}"
                     for name in names for r, (rc, text) in
                     enumerate(out[name]))


def _final_val(run):
    return [ln for ln in run[0][1].splitlines() if ln.startswith("final val")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Two ranks: an unstopped run, and a run whose rank 1 alone is sent
    SIGTERM once step PREEMPT_AFTER is logged, then resumed. Records each
    run's ranks' exit codes and output, and the step ``at`` that the
    stopped run checkpointed (None when rank 0 printed none)."""
    root = tmp_path_factory.mktemp("cli")
    save = str(root / "runs")
    logs = {k: str(root / k) for k in ("whole", "stop", "resume")}
    for d in logs.values():
        os.makedirs(d)
    whole, whole_store = _rank_procs(["train", *CLI, "--save_dir", save,
                                      "--exp_name", "whole"], D,
                                     logs["whole"])
    stop, stop_store = _rank_procs(["train", *CLI, "--save_dir", save,
                                    "--exp_name", "stopped"], D, logs["stop"])
    deadline = time.time() + RUN_WAIT
    while not any(r.get("step", 0) >= PREEMPT_AFTER and "train/loss" in r
                  for r in _rows(save, "stopped")):
        assert time.time() < deadline and stop[1][0].poll() is None, \
            "the run to stop ended or stalled"
        time.sleep(0.05)
    stop[1][0].send_signal(signal.SIGTERM)
    out = {"whole": _finish(whole, logs["whole"]),
           "stop": _finish(stop, logs["stop"])}
    del whole_store, stop_store   # their ranks have exited
    ckpts = sorted(os.listdir(os.path.join(save, "ckpts", "stopped")))
    resume, resume_store = _rank_procs(["train", *CLI, "--save_dir", save,
                                        "--exp_name", "stopped",
                                        "--auto_resume"], D, logs["resume"])
    out["resume"] = _finish(resume, logs["resume"])
    del resume_store
    n_steps = max(r["step"] for r in _rows(save, "whole"))
    m = [ln for ln in out["stop"][0][1].splitlines()
         if ln.startswith("preempted")]
    return dict(save=save, out=out, ckpts_at_stop=ckpts, n_steps=n_steps,
                at=int(m[0].rsplit(" ", 1)[1]) if m else None,
                rcs={k: [rc for rc, _ in v] for k, v in out.items()})


def test_sigterm_to_one_rank_stops_both_at_one_step(cli_runs):
    (rc0, t0), (rc1, t1) = cli_runs["out"]["stop"]
    assert rc0 == 0 and rc1 == 0, t0 + t1
    m = [ln for ln in t0.splitlines() if ln.startswith("preempted")]
    assert len(m) == 1, t0
    at = int(m[0].rsplit(" ", 1)[1])
    assert PREEMPT_AFTER <= at < cli_runs["n_steps"]
    assert "preempted" not in t1          # rank 0 alone prints
    pts = [c for c in cli_runs["ckpts_at_stop"] if c.endswith(".pt")]
    assert pts[-1] == f"{at}.pt" and "weights.npz" in \
        cli_runs["ckpts_at_stop"]


def test_resumed_two_rank_run_is_the_unstopped_run(cli_runs):
    out, n = cli_runs["out"], cli_runs["n_steps"]
    why = (f"stopped at step {cli_runs['at']} of {n}; exit codes "
           f"{cli_runs['rcs']}")
    for name in ("resume", "whole"):
        for r, (rc, _) in enumerate(out[name]):
            assert rc == 0, (f"the {name} run's rank {r} exited {rc} "
                             f"({why}):\n{_tails(out, [name])}")
    whole_val, resumed_val = _final_val(out["whole"]), \
        _final_val(out["resume"])
    assert whole_val and whole_val == resumed_val, (
        f"final val: whole {whole_val}, resume {resumed_val} ({why}):\n"
        f"{_tails(out, ['whole', 'resume'])}")
    _same_state(_ckpt(cli_runs["save"], "stopped", n),
                _ckpt(cli_runs["save"], "whole", n),
                f"the resumed run's step-{n} checkpoint against the "
                f"unstopped run's ({why})")


def test_one_process_resumes_a_two_rank_checkpoint(cli_runs, tmp_path):
    """World size is not part of the checkpoint: a D = 1 Trainer restores
    a D = 2 checkpoint exactly (parameters, Adam, cache, generator) and
    steps on from it."""
    save, n = cli_runs["save"], cli_runs["n_steps"]
    cfg = get_config([*CLI[:-2], "--save_dir", str(tmp_path),
                      "--exp_name", "one", "--ckpt_path",
                      os.path.join(save, "ckpts", "whole")])
    tr = Trainer(cfg, make_synthetic_scene(appearance_wh=(32, 24)),
                 device="cpu")
    _same_state(state_payload(tr.state), _ckpt(save, "whole", n))
    batch = next(tr.pipeline.epoch_batches(1, G))
    state, m = tr.step_fn(tr.state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()
                                     if k != "image_idx"})
    assert state.step == n + 1 and np.isfinite(float(m["loss"]))


def test_num_devices_against_the_launcher(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    assert mesh.resolve_world(0, "cpu") == 2
    assert mesh.resolve_world(2, "cpu") == 2
    with pytest.raises(ValueError, match="WORLD_SIZE=2"):
        mesh.resolve_world(3, "cpu")
    monkeypatch.delenv("WORLD_SIZE")
    assert mesh.resolve_world(0, "cpu") == 1
    assert mesh.resolve_world(3, "cpu") == 3


def test_two_devices_on_cuda_without_a_card_are_refused(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    argv = ["train", *CLI[:-2], "--num_devices", "2", "--device", "cuda",
            "--save_dir", str(tmp_path)]
    out = subprocess.run([sys.executable, "-m", "crnerf_tpu_torch", *argv],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_shard_rows_pad_to_a_multiple_of_the_ranks():
    x = torch.arange(5)[:, None]
    parts = [mesh.local_rows(x, 4, r) for r in range(4)]
    assert [mesh.shard_rows(5, 4, r) for r in range(4)] == [
        (0, 2), (2, 4), (4, 6), (6, 8)]
    assert torch.equal(torch.cat(parts)[:5], x)
    assert parts[3].tolist() == [[4], [4]]
