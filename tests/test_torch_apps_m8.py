"""The apps that need an image codec, as a user runs them on the CPU, the
port's codecs standing in for PIL and imageio: eval's camera-path ``test``
split (its frames the in-process Renderer's bits and within one level of
crnerf_tpu's eval PNGs on the same weights, its GIF, the mp4 warning), the
``video`` app, ``metrics`` (crnerf_tpu's scores within 1e-5, the missing
render), serve's ``render_path``, ``train`` / ``eval`` / ``metrics`` on a
Blender scene with the perturbations, panels and a profiler window, PIL,
imageio and cv2 blocked; and the Trainer's panels and profiler leaving the
run's bits as they are."""

import dataclasses
import glob
import os
import re
import shutil
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from crnerf_tpu_torch.apps import eval as eval_app
from crnerf_tpu_torch.apps.serve import RenderService, load_style, load_system
from crnerf_tpu_torch.config import build_parser, config_from_args
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene
from crnerf_tpu_torch.render import camera_path
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.train.loop import Trainer
from crnerf_tpu_torch.utils.logging import MetricLogger
from crnerf_tpu_torch.utils.png import read_png
from crnerf_tpu_torch.utils.visualization import palette, quantize
from test_torch_apps import REPO, TINY, cli_run  # noqa: F401 (the fixture)
from test_torch_codecs import CODEC_MODULES
from test_torch_trainer import _assert_same_bits, _full_state

torch.set_num_threads(2)   # as the CLI's subprocesses (OMP_NUM_THREADS)

PATH_WH = (24, 18)
PATH_FRAMES = 3
MP4_WARNING = (r"^mp4 backend unavailable \(.*\); wrote (\S+\.gif) instead\. "
               r"Install imageio\[ffmpeg\] for mp4 output\.$")

# the codecs blocked, then ``python -m crnerf_tpu_torch`` with the rest of
# the command line
_BLOCKED = ("import runpy, sys\n"
            f"for m in {CODEC_MODULES!r}:\n"
            "    sys.modules[m] = None\n"
            "sys.argv = ['crnerf_tpu_torch'] + sys.argv[1:]\n"
            "runpy.run_module('crnerf_tpu_torch', run_name='__main__')\n")


def cli_blocked(*argv):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-c", _BLOCKED, *argv], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)


def block_codecs(monkeypatch):
    for name in CODEC_MODULES:
        monkeypatch.setitem(sys.modules, name, None)


def _mp4_warnings(w):
    return [str(x.message) for x in w
            if str(x.message).startswith("mp4 backend")]


def _gif_frames(path):
    im = Image.open(path)
    assert im.info["loop"] == 0
    return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


@pytest.fixture(scope="module")
def path_run(cli_run, tmp_path_factory):  # noqa: F811
    """eval --split test of the CLI run's checkpoint, by the port (in
    process, as ``python -m crnerf_tpu_torch eval`` calls it) and by
    crnerf_tpu's eval app, both asked for mp4."""
    ckpt = os.path.join(cli_run["save"], "ckpts", "e")
    common = [a for a in cli_run["common"] if a not in ("--device", "cpu")]
    path = ["--split", "test", "--scene_name", "cli_brandenburg_gate",
            "--num_frames", str(PATH_FRAMES), "--img_wh", *map(str, PATH_WH),
            "--ckpt_path", ckpt, "--video_format", "mp4"]
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = eval_app.main(common + path + ["--device", "cpu"])
    port_warn = _mp4_warnings(w)
    jsave = str(tmp_path_factory.mktemp("jax"))
    jcommon = list(common)
    jcommon[jcommon.index("--save_dir") + 1] = jsave
    from crnerf_tpu.apps.eval import main as jax_eval

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jout = jax_eval(jcommon + path + ["--num_devices", "1"])
    cfg = config_from_args(build_parser().parse_args(common + path))
    return dict(out=out, jout=jout, port_warn=port_warn,
                jax_warn=_mp4_warnings(w), cfg=cfg, ckpt=ckpt)


def test_eval_test_split_frames_are_the_renderer_s(
        path_run, cli_run):  # noqa: F811
    cfg, out = path_run["cfg"], path_run["out"]
    assert out.endswith(os.path.join("phototourism", "cli_brandenburg_gate"))
    pngs = sorted(glob.glob(os.path.join(out, "*.png")))
    assert [os.path.basename(p) for p in pngs] == [
        f"{i:03d}.png" for i in range(PATH_FRAMES)]
    spec = dataclasses.replace(camera_path.PATH_PRESETS["brandenburg_gate"],
                               n_frames=PATH_FRAMES)
    style, anchor = eval_app.path_anchors(cli_run["scene"], spec)
    # the preset's ids are past this scene's: both fall back to the last
    # train image
    assert style is anchor is cli_run["scene"].train_images[-1]
    renderer = Renderer(cfg, load_system(cfg, path_run["ckpt"],
                                         torch.device("cpu")))
    K = camera_path.fov_intrinsics(PATH_WH)
    w, h = PATH_WH
    frames = []
    for i, c2w in enumerate(spec.poses(anchor.c2w)):
        want = renderer.fetch(renderer.render_frame_cam_async(
            c2w, K, anchor.near, anchor.far, (h, w),
            style.appearance[None].astype(np.float32),
            outputs="rgb_u8"))["rgb_u8"]
        got = read_png(pngs[i])
        assert got.shape == (h, w, 3) and np.array_equal(got, want)
        frames.append(got)
    gif = _gif_frames(os.path.join(out, "cli_brandenburg_gate.gif"))
    assert len(gif) == PATH_FRAMES
    for f, g in zip(frames, gif):
        assert np.array_equal(g, palette()[quantize(f)])


def test_eval_test_split_within_a_level_of_jax(path_run):
    """fp32 at the same weights: at most one u8 level apart (truncation at
    a boundary, tests/test_torch_slice.py)."""
    got = sorted(glob.glob(os.path.join(path_run["out"], "*.png")))
    want = sorted(glob.glob(os.path.join(path_run["jout"], "*.png")))
    assert len(got) == len(want) == PATH_FRAMES
    for g, w in zip(got, want):
        d = np.abs(read_png(g).astype(int) - np.asarray(Image.open(w)))
        assert d.max() <= 1, d.max()


def test_eval_test_split_warns_on_mp4_as_jax(path_run):
    for who in ("port", "jax"):
        msgs = path_run[f"{who}_warn"]
        assert len(msgs) == 1, (who, msgs)
        m = re.match(MP4_WARNING, msgs[0], re.S)
        assert m and m.group(1).endswith("cli_brandenburg_gate.gif")
        assert os.path.exists(m.group(1))


def test_eval_test_split_from_host_rays(path_run, tmp_path):
    """--no-cam_rays: the path's host rays (test_path_rays), within one
    level of the frames made from the camera on the device."""
    cfg = path_run["cfg"].replace(cam_rays=False, save_dir=str(tmp_path),
                                  video_format="gif")
    out = eval_app.run(cfg, torch.device("cpu"))
    for i in range(PATH_FRAMES):
        a = read_png(os.path.join(out, f"{i:03d}.png")).astype(int)
        b = read_png(os.path.join(path_run["out"], f"{i:03d}.png"))
        assert np.abs(a - b).max() <= 1
    assert len(_gif_frames(os.path.join(out, "cli_brandenburg_gate.gif"))) \
        == PATH_FRAMES


def _style_pngs(d, n=2):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(3)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (30, 41, 3), dtype=np.uint8)
                        ).save(os.path.join(d, f"style{i}.png"))
    return sorted(glob.glob(os.path.join(d, "*.png")))


def test_video_app(cli_run, tmp_path, monkeypatch):  # noqa: F811
    from crnerf_tpu.apps.video import _load_style as jax_load_style
    from crnerf_tpu_torch.apps import video as video_app

    styles = _style_pngs(str(tmp_path / "styles"))
    wts = os.path.join(cli_run["save"], "ckpts", "e", "weights.npz")
    argv = ["--ckpt_path", wts, "--scene_name", "cli_trevi_fountain",
            "--style_dir", str(tmp_path / "styles"), "--save_dir",
            str(tmp_path / "out"), "--img_wh", *map(str, PATH_WH),
            "--N_samples", "8", "--N_importance", "8", "--chunk", "512",
            "--n_frames", "2", "--netdepth", "2", "--netwidth", "32",
            "--nerf_out_dim", "16", "--appearance_wh", "64", "48",
            "--device", "cpu"]
    with monkeypatch.context() as m:
        for name in CODEC_MODULES:
            m.setitem(sys.modules, name, None)
        got_styles = [load_style(p, (64, 48)) for p in styles]
        outs = video_app.main(argv)
    for p, got in zip(styles, got_styles):   # PIL's bytes, without PIL
        assert np.array_equal(got, jax_load_style(p, (64, 48)))
    assert [os.path.basename(o) for o in outs] == ["style0", "style1"]
    cfg = config_from_args(build_parser().parse_args(
        ["--netdepth", "2", "--netwidth", "32", "--nerf_out_dim", "16",
         "--N_samples", "8", "--N_importance", "8", "--chunk", "512",
         "--appearance_wh", "64", "48", "--no-use_mask",
         "--no-encode_random"]))
    renderer = Renderer(cfg, load_system(cfg, wts, torch.device("cpu")))
    anchor = camera_path.DEMO_ANCHORS["trevi_fountain"]
    spec = dataclasses.replace(camera_path.PATH_PRESETS["trevi_fountain"],
                               n_frames=2)
    w, h = PATH_WH
    for out, style in zip(outs, got_styles):
        frames = [read_png(os.path.join(out, f"{i:03d}.png"))
                  for i in range(2)]
        for i, c2w in enumerate(spec.poses(anchor)):
            want = renderer.fetch(renderer.render_frame_cam_async(
                c2w, camera_path.fov_intrinsics(PATH_WH), 0.0, 5.0, (h, w),
                style, outputs="rgb_u8"))["rgb_u8"]
            assert np.array_equal(frames[i], want)
        gif = _gif_frames(os.path.join(out, os.path.basename(out) + ".gif"))
        assert len(gif) == 2
        for f, g in zip(frames, gif):
            assert np.array_equal(g, palette()[quantize(f)])


def _metric_dir(cli_run, tmp_path):  # noqa: F811
    """A copy of the CLI run's test_test renders, and the metrics app's
    arguments for it."""
    src = os.path.join(cli_run["save"], "results", "phototourism", "cli")
    dst = tmp_path / "results" / "phototourism" / "cli"
    shutil.copytree(src, dst)
    for p in glob.glob(str(dst / "*.txt")):
        os.remove(p)
    return dst, ["--root_dir", cli_run["root"], "--dataset_name",
                 "phototourism", "--scene_name", "cli", "--save_dir",
                 str(tmp_path), "--img_downscale", "2"]


def test_metrics_app_matches_jax(
        cli_run, tmp_path, monkeypatch, capsys):  # noqa: F811
    from crnerf_tpu.apps.eval_metric import main as jax_metrics
    from crnerf_tpu_torch.apps import eval_metric

    dst, argv = _metric_dir(cli_run, tmp_path)
    want = jax_metrics(argv)
    block_codecs(monkeypatch)
    got = eval_metric.main(argv + ["--device", "cpu"])
    # no weights file in the repo: LPIPS is skipped with the JAX app's line
    assert ("lpips unavailable (LPIPS weights not found"
            in capsys.readouterr().out)
    assert set(got) == {"psnr", "ssim", "mse"} <= set(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k
    lines = (dst / "result.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[1].startswith("cli n=2 psnr=")
    # a half-finished render directory fails
    os.remove(dst / "001.png")
    with pytest.raises(FileNotFoundError, match="expected 2 renders"):
        eval_metric.main(argv + ["--device", "cpu"])


def test_metrics_score_pair_is_jax_s():
    from crnerf_tpu.apps.eval_metric import score_pair as jax_score
    from crnerf_tpu_torch.apps.eval_metric import score_pair

    rng = np.random.default_rng(0)
    gt = rng.uniform(0, 1, (18, 25, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(
        np.float32)
    got, want = score_pair(pred, gt), jax_score(pred, gt)
    assert set(got) == set(want) == {"psnr", "ssim", "mse"}
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_serve_render_path(cli_run, tmp_path, monkeypatch):  # noqa: F811
    cfg = config_from_args(build_parser().parse_args(
        [a for a in cli_run["common"] if a not in ("--device", "cpu")]
        + ["--no-use_mask"]))
    svc = RenderService(cfg, load_system(
        cfg, os.path.join(cli_run["save"], "ckpts", "e"),
        torch.device("cpu")))
    style_png = _style_pngs(str(tmp_path / "styles"), 1)[0]
    block_codecs(monkeypatch)
    assert svc.handle({"op": "encode_style", "id": "s",
                       "image_path": style_png})["ok"]
    out_dir = str(tmp_path / "path")
    r = svc.handle({"op": "render_path", "scene": "cli_brandenburg_gate",
                    "n_frames": 3, "wh": list(PATH_WH), "style_id": "s",
                    "out_dir": out_dir})
    assert r["ok"], r
    assert r["frames"] == 3 and r["out_dir"] == out_dir
    assert r["gif"] == os.path.join(out_dir, "brandenburg_gate.gif")
    assert r["ms_total"] > 0
    spec = dataclasses.replace(camera_path.PATH_PRESETS["brandenburg_gate"],
                               n_frames=3)
    anchor = camera_path.DEMO_ANCHORS["brandenburg_gate"]
    w, h = PATH_WH
    for i, c2w in enumerate(spec.poses(anchor)):
        want = svc.renderer.fetch(svc.renderer.render_frame_cam_async(
            c2w, camera_path.fov_intrinsics(PATH_WH), 0.0, 5.0, (h, w),
            svc.styles["s"], outputs="rgb_u8"))["rgb_u8"]
        assert np.array_equal(
            read_png(os.path.join(out_dir, f"{i:03d}.png")), want)
    assert os.path.exists(r["gif"])
    for req, err in (({"scene": "brandenburg_gate"}, "needs out_dir"),
                     ({"scene": "nowhere", "out_dir": out_dir},
                      "no camera-path preset"),
                     ({"scene": "sacre_coeur", "out_dir": out_dir},
                      "no demo anchor")):
        r = svc.handle({"op": "render_path", "style_id": "s", **req})
        assert not r["ok"] and err in r["error"], r


@pytest.fixture(scope="module")
def blender_run(tmp_path_factory):
    """A Blender scene (3 train and 2 test frames of 400 x 400 RGBA, as
    tests/test_apps.py's fixture), trained for one epoch with color + occ,
    panels every 2 steps and a profiler window, then evaluated and scored,
    each in a subprocess with PIL, imageio and cv2 blocked."""
    import json

    d = tmp_path_factory.mktemp("blender")
    root, save = d / "lego", str(d / "out")
    rng = np.random.RandomState(0)
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        for t in range(n):
            name = f"{split}_{t}"
            arr = np.zeros((400, 400, 4), np.uint8)
            arr[..., :3] = rng.randint(0, 255, (400, 400, 3))
            arr[..., 3] = 255
            root.mkdir(exist_ok=True)
            Image.fromarray(arr, "RGBA").save(root / f"{name}.png")
            pose = np.eye(4)
            pose[2, 3] = 4.0
            pose[0, 3] = 0.3 * t
            frames.append({"file_path": name,
                           "transform_matrix": pose.tolist()})
        (root / f"transforms_{split}.json").write_text(json.dumps(
            {"camera_angle_x": 0.6911, "frames": frames}))
    # 8 x 8 grids: the appearance encoder's reflect padding needs the
    # re-encoded random-style grid at least that large
    common = ["--root_dir", str(root), "--dataset_name", "blender",
              "--img_wh", "32", "32", "--batch_size", "64", "--N_samples",
              "4", "--N_importance", "4", "--netdepth", "2", "--netwidth",
              "16", "--nerf_out_dim", "8", "--N_vocab", "8",
              "--appearance_wh", "32", "24", "--chunk", "256", "--val_chunk",
              "256", "--save_dir", save, "--exp_name", "bl", "--scene_name",
              "lego", "--device", "cpu"]
    train = cli_blocked("train", *common, "--data_perturb", "color", "occ",
                        "--num_epochs", "1", "--log_every", "1000",
                        "--img_panel_every", "2", "--profile",
                        "--profile_steps", "1", "3")
    ev = cli_blocked("eval", *common, "--split", "test_test", "--ckpt_path",
                     os.path.join(save, "ckpts", "bl"))
    met = cli_blocked("metrics", "--root_dir", str(root), "--dataset_name",
                      "blender", "--scene_name", "lego", "--save_dir", save,
                      "--img_wh", "32", "32", "--device", "cpu")
    return dict(save=save, train=train, eval=ev, metrics=met)


def test_blender_train_cli(blender_run):
    r, save = blender_run["train"], blender_run["save"]
    assert r.returncode == 0, r.stderr[-4000:]
    assert "final val: psnr=" in r.stdout
    assert os.path.exists(os.path.join(save, "ckpts", "bl", "weights.npz"))
    images = os.listdir(os.path.join(save, "logs", "bl", "images"))
    for name in ("gt", "pred", "pred_random", "mask"):
        assert f"train_{name}_00000002.png" in images, name
    # 3 x 1024 rays in grids of 64: 48 steps, a panel set every 2
    assert sum(x.startswith("train_gt_") for x in images) == 24
    assert os.listdir(os.path.join(save, "traces", "bl")) == [
        "steps_1_3.trace.json"]


def test_blender_eval_and_metrics_cli(blender_run):
    r = blender_run["eval"]
    assert r.returncode == 0, r.stderr[-4000:]
    assert "rendered 2 images" in r.stdout
    out = os.path.join(blender_run["save"], "results", "blender", "lego")
    for i in range(2):
        assert read_png(os.path.join(out, f"{i:03d}.png")).shape == (
            32, 32, 3)
    m = blender_run["metrics"]
    assert m.returncode == 0, m.stderr[-4000:]
    line = re.search(r"lego n=2 psnr=(\S+) ssim=(\S+) mse=(\S+)", m.stdout)
    assert line and all(np.isfinite(float(x)) for x in line.groups())


def test_panels_and_profiler_keep_the_run_s_bits(tmp_path):
    """The same fit with panels every 2 steps and a profiler window, and
    without: the same final state, bit for bit; the panels and the trace
    on disk."""
    cfg = config_from_args(build_parser().parse_args(
        TINY + ["--num_epochs", "1", "--val_every_epochs", "0",
                "--log_every", "1000", "--N_vocab", "12"]))
    scene = make_synthetic_scene(n_train=2, n_test=0, img_wh=(24, 18),
                                 appearance_wh=(64, 48))
    states = {}
    for name, extra in (("panels", dict(img_panel_every=2, profile=True,
                                        profile_steps=(1, 3))),
                        ("plain", dict(img_panel_every=0))):
        c = cfg.replace(save_dir=str(tmp_path / name), exp_name=name,
                        **extra)
        logger = MetricLogger(str(tmp_path / name / "logs"), name)
        tr = Trainer(c, scene, logger=logger, device="cpu")
        tr.fit()
        logger.close()
        states[name] = _full_state(tr)
    assert int(states["panels"]["step"]) == 6
    _assert_same_bits(states["panels"], states["plain"])
    images = os.listdir(tmp_path / "panels" / "logs" / "panels" / "images")
    assert sorted(images) == sorted(
        f"train_{n}_{s:08d}.png" for s in (2, 4, 6)
        for n in ("gt", "pred", "pred_random", "mask"))
    assert os.listdir(tmp_path / "panels" / "traces" / "panels") == [
        "steps_1_3.trace.json"]
    assert not os.path.exists(tmp_path / "plain" / "traces")
