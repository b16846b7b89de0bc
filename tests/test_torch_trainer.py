"""The port's Trainer on the CPU at a tiny fp32 config: ``fit`` is a loop
of ``make_train_step`` over the pipeline's batches (bit for bit), a fit
stopped mid-epoch and resumed from its checkpoint in a fresh Trainer is
the unstopped fit (bit for bit), a same-step re-save is skipped, the
checkpoint manager keeps the newest three, selective loading by prefix,
validation leaves the system in train mode, and the ``weights.npz`` the
Trainer writes renders in the JAX package's Renderer as it does in the
port's."""

import os

import jax
import numpy as np
import pytest
import torch

from crnerf_tpu.config import Config as JaxConfig
from crnerf_tpu.render.inference import Renderer as JaxRenderer
from crnerf_tpu.utils.checkpoint import load_weights_only
from crnerf_tpu_torch import Config
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.utils import checkpoint as ckpt
from crnerf_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(2)

CFG = Config(batch_size=64, grids_per_step=2, N_samples=8, N_importance=8,
             netdepth=2, netwidth=32, nerf_out_dim=16, N_emb_xyz=10,
             N_vocab=10, appearance_wh=(64, 48), num_epochs=2, val_chunk=256,
             chunk=256, log_every=3)
STOP_AT = 5          # mid epoch 0 (13 steps an epoch)
# tests/test_torch_slice.py's bound on rgb in [0, 1] at fp32
RGB_TOL = 5e-4


@pytest.fixture(scope="module")
def scene():
    return make_synthetic_scene(n_train=4, n_test=1, img_wh=(24, 18),
                                appearance_wh=CFG.appearance_wh)


def _full_state(tr: Trainer):
    """Every number a step reads, on the host."""
    st = tr.state
    opt = st.optimizer.state_dict()["state"]
    out = {f"system.{k}": v.clone() for k, v in st.system.state_dict().items()}
    for i, s in opt.items():
        for k, v in s.items():
            out[f"adam.{i}.{k}"] = torch.as_tensor(v).clone()
    out["embedding_cache"] = st.embedding_cache.clone()
    out["embedding_valid"] = st.embedding_valid.clone()
    out["generator"] = st.generator.get_state()
    out["step"] = torch.tensor(st.step)
    out["has_any"] = torch.tensor(st.has_any)
    return out


def _assert_same_bits(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.fixture(scope="module")
def runs(scene, tmp_path_factory):
    """An unstopped fit, and a fit stopped after STOP_AT steps then resumed
    in a fresh Trainer (auto_resume)."""
    d = str(tmp_path_factory.mktemp("trainer"))
    cfg = CFG.replace(save_dir=d)
    whole = Trainer(cfg.replace(exp_name="whole"), scene,
                    MetricLogger(os.path.join(d, "logs"), "whole"),
                    device="cpu")
    whole.fit()
    stopped = Trainer(cfg.replace(exp_name="stopped"), scene, device="cpu")
    step_fn = stopped.step_fn

    def stop_after(state, batch, draws=None):
        out = step_fn(state, batch, draws)
        if state.step == STOP_AT:
            stopped.request_stop()
        return out

    stopped.step_fn = stop_after
    stopped.fit()
    at_stop = _full_state(stopped)
    steps_at_stop = stopped.ckpt.all_steps()
    resumed = Trainer(cfg.replace(exp_name="stopped", auto_resume=True),
                      scene, device="cpu")
    restored = _full_state(resumed)
    resumed.fit()
    return dict(dir=d, cfg=cfg, whole=whole, stopped=stopped,
                at_stop=at_stop, steps_at_stop=steps_at_stop,
                restored=restored, resumed=resumed)


def test_fit_is_the_step_loop_over_the_pipeline(runs, scene):
    whole = runs["whole"]
    hand = Trainer(runs["cfg"].replace(exp_name="hand"), scene, device="cpu")
    for epoch in range(CFG.num_epochs):
        for i in range(hand.iters_per_epoch):
            b = hand.pipeline.make_global_batch(epoch, i, CFG.grids_per_step)
            hand.step_fn(hand.state, {k: torch.from_numpy(v)
                                      for k, v in b.items()
                                      if k != "image_idx"})
    assert whole.state.step == 2 * whole.iters_per_epoch == 26
    _assert_same_bits(_full_state(whole), _full_state(hand))


def test_stopped_fit_checkpoints_where_it_stopped(runs):
    st = runs["stopped"]
    assert st.stopped and not st.completed
    assert runs["steps_at_stop"] == [STOP_AT]
    assert not st.has_unsaved_progress
    _assert_same_bits(runs["restored"], runs["at_stop"])


def test_resumed_fit_is_the_unstopped_fit(runs):
    assert runs["resumed"].completed
    _assert_same_bits(_full_state(runs["resumed"]),
                      _full_state(runs["whole"]))


def test_checkpoints_and_metrics_on_disk(runs):
    d, whole = runs["dir"], runs["whole"]
    assert whole.ckpt.all_steps() == [13, 26]
    assert os.path.exists(os.path.join(whole.ckpt.directory, "weights.npz"))
    with open(os.path.join(d, "logs", "whole", "metrics.jsonl")) as f:
        rows = [__import__("json").loads(line) for line in f]
    steps = [r["step"] for r in rows if "train/loss" in r]
    assert steps == list(range(3, 27, 3))
    assert sum("val/psnr" in r for r in rows) == 2
    images = os.listdir(os.path.join(d, "logs", "whole", "images"))
    assert {f"val_{k}_00000026.png" for k in ("gt", "pred", "depth",
                                              "mask")} <= set(images)


def test_same_step_resave_is_skipped(runs, monkeypatch):
    whole = runs["whole"]
    calls = []
    monkeypatch.setattr(whole.ckpt, "save", lambda *a: calls.append(a))
    whole._save_checkpoint(whole.state.step)
    assert calls == []
    whole._save_checkpoint(whole.state.step + 1)
    assert len(calls) == 1


def test_a_weights_bundle_is_refused_for_resume(runs):
    with pytest.raises(ValueError, match="weights.npz"):
        runs["whole"].restore("weights.npz")


def test_validate_leaves_the_system_in_train_mode(runs):
    whole = runs["whole"]
    whole.system.eval()
    val = whole.validate()
    assert whole.system.training
    assert all(m.training for m in whole.system.modules())
    assert np.isfinite(val["psnr"]) and 0 < val["ssim"] <= 1


def test_manager_keeps_the_newest(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path), max_to_keep=3)
    for s in (4, 1, 9, 7, 12):
        mgr.save(s, {"step": s})
    assert mgr.all_steps() == [7, 9, 12] and mgr.latest_step() == 12
    assert mgr.load()["step"] == 12 and mgr.load(7)["step"] == 7
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.CheckpointManager(str(tmp_path / "empty")).load()


def test_selective_load_by_prefix(runs):
    sd = runs["whole"].system.state_dict()
    other = {k: v + 1 for k, v in sd.items() if v.is_floating_point()}
    sub = ckpt.extract_submodule(other, "nerf_fine")
    assert sub and all(k.split(".")[0] != "nerf_fine" for k in sub)
    with pytest.raises(KeyError, match="nope"):
        ckpt.extract_submodule(other, "nope")
    merged = ckpt.load_selective(sd, other, prefixes_to_ignore=("enc_a",))
    for k, v in merged.items():
        top = k.split(".")[0]
        want = sd[k] if (top == "enc_a" or k not in other) else other[k]
        assert v is want, k


def test_weights_bundle_renders_in_the_jax_renderer(runs, scene):
    whole = runs["whole"]
    path = os.path.join(whole.ckpt.directory, "weights.npz")
    im = scene.test_images[0]
    w, h = im.wh
    style = im.appearance[None].astype(np.float32)
    r = Renderer(CFG, whole.system, torch.device("cpu"))
    got = r.fetch(r.render_frame_cam_async(im.c2w, im.K, im.near, im.far,
                                           (h, w), style))
    whole.system.train()
    jcfg = JaxConfig(**{k: getattr(CFG, k) for k in (
        "batch_size", "N_samples", "N_importance", "netdepth", "netwidth",
        "nerf_out_dim", "N_emb_xyz", "N_vocab", "appearance_wh", "chunk")},
        use_pallas=False)
    jr = JaxRenderer(jcfg, load_weights_only(path))
    want = jr.fetch(jr.render_frame_cam_async(im.c2w, im.K, im.near, im.far,
                                              (h, w), style))
    np.testing.assert_allclose(got["rgb"], np.asarray(want["rgb"]),
                               atol=RGB_TOL, rtol=0)
    assert jax.devices()[0].platform == "cpu"
