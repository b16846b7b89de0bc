"""The port's CLI as a user runs it, on the CPU: ``python -m
crnerf_tpu_torch train`` on a phototourism cache, then ``eval`` of its
checkpoint directory (PNGs of the test images, the in-process render's
bits), an empty split (exit 0), the refused splits, the command table; the reference
checkpoint converter against crnerf_tpu's on a synthetic state dict, and
the converted weights through the bridge into the port's system; the PNG
writer, the depth panel and the metric logger."""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from crnerf_tpu_torch import Config
from crnerf_tpu_torch.data.phototourism import save_scene_cache
from crnerf_tpu_torch.data.synthetic import make_synthetic_scene

torch.set_num_threads(2)   # as the CLI's subprocesses (OMP_NUM_THREADS)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--batch_size", "64", "--grids_per_step", "2", "--N_samples", "8",
        "--N_importance", "8", "--netdepth", "2", "--netwidth", "32",
        "--nerf_out_dim", "16", "--N_vocab", "12", "--appearance_wh", "64",
        "48", "--chunk", "512", "--val_chunk", "512"]


def _cli(*argv, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2",
               **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", "crnerf_tpu_torch", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)


def _decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB, filter 0 (what utils/png.py writes)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h = int.from_bytes(body[:4], "big"), int.from_bytes(
                body[4:8], "big")
        elif tag == b"IDAT":
            idat += body
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert not raw[:, 0].any()
    return raw[:, 1:].reshape(h, w, 3)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """A phototourism cache (4 train, 2 test images), trained for one
    epoch through the CLI, then evaluated."""
    d = tmp_path_factory.mktemp("cli")
    root, save = str(d / "scene"), str(d / "out")
    scene = make_synthetic_scene(n_train=4, n_test=2, img_wh=(24, 18),
                                 appearance_wh=(64, 48))
    save_scene_cache(scene, root_dir=root, img_downscale=2)
    common = ["--dataset_name", "phototourism", "--root_dir", root,
              "--scene_name", "cli", "--save_dir", save, "--exp_name", "e",
              "--device", "cpu", *TINY]
    train = _cli("train", *common, "--num_epochs", "1", "--log_every", "4")
    ev = _cli("eval", *common, "--split", "test_test", "--ckpt_path",
              os.path.join(save, "ckpts", "e"))
    return dict(scene=scene, root=root, save=save, common=common,
                train=train, eval=ev)


def test_train_cli(cli_run):
    r = cli_run["train"]
    assert r.returncode == 0, r.stderr
    assert "final val: psnr=" in r.stdout
    save = cli_run["save"]
    with open(os.path.join(save, "logs", "e", "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [x["step"] for x in rows if "train/loss" in x] == [4, 8, 12]
    assert any("val/psnr" in x for x in rows)
    ck = os.path.join(save, "ckpts", "e")
    assert sorted(os.listdir(ck)) == ["13.pt", "weights.npz"]
    codes = os.path.join(save, "logs", "e", "codes")
    assert Config.from_json(open(os.path.join(codes, "config.json")).read()
                            ).root_dir == cli_run["root"]
    assert os.path.exists(os.path.join(codes, "crnerf_tpu_torch",
                                       "train", "loop.py"))


def test_eval_cli_writes_the_renderer_s_frames(cli_run):
    r = cli_run["eval"]
    assert r.returncode == 0, r.stderr
    assert "rendered 2 images" in r.stdout and "p95" in r.stdout
    from crnerf_tpu_torch.apps.serve import load_system
    from crnerf_tpu_torch.config import build_parser, config_from_args
    from crnerf_tpu_torch.render.inference import Renderer

    cfg = config_from_args(build_parser().parse_args(
        [a for a in cli_run["common"] if a not in ("--device", "cpu")]))
    renderer = Renderer(cfg, load_system(
        cfg, os.path.join(cli_run["save"], "ckpts", "e"),
        torch.device("cpu")))
    out = os.path.join(cli_run["save"], "results", "phototourism", "cli")
    for i, im in enumerate(cli_run["scene"].test_images):
        w, h = im.wh
        want = renderer.fetch(renderer.render_frame_cam_async(
            im.c2w, im.K, im.near, im.far, (h, w),
            im.appearance[None].astype(np.float32),
            outputs="rgb_u8"))["rgb_u8"]
        with open(os.path.join(out, f"{i:03d}.png"), "rb") as f:
            got = _decode_png(f.read())
        assert got.shape == want.shape == (h, w, 3)
        assert np.array_equal(got, want)


def test_eval_of_an_empty_split_exits_0(cli_run, tmp_path):
    root = str(tmp_path / "empty")
    save_scene_cache(make_synthetic_scene(n_train=1, n_test=0,
                                          img_wh=(24, 18),
                                          appearance_wh=(64, 48)),
                     root_dir=root, img_downscale=2)
    common = list(cli_run["common"])
    common[common.index("--root_dir") + 1] = root
    r = _cli("eval", *common, "--split", "test_test", "--ckpt_path",
             os.path.join(cli_run["save"], "ckpts", "e"))
    assert r.returncode == 0, r.stderr
    assert "rendered 0 images" in r.stdout


@pytest.mark.parametrize("split,error", [("test", "no camera-path preset"),
                                         ("nope", "unsupported split")])
def test_eval_refuses_other_splits(cli_run, split, error):
    """An unknown split; the camera-path split on a scene with no preset
    (``cli``)."""
    from crnerf_tpu_torch.apps import eval as eval_app

    with pytest.raises((KeyError, ValueError), match=error):
        eval_app.main([*cli_run["common"], "--split", split, "--ckpt_path",
                       os.path.join(cli_run["save"], "ckpts", "e")])


def test_command_table():
    import importlib

    from crnerf_tpu_torch.__main__ import COMMANDS

    assert set(COMMANDS) == {"prepare", "train", "eval", "metrics", "video",
                             "serve"}
    for mod in COMMANDS.values():
        assert hasattr(importlib.import_module(mod), "main")


def _reference_state_dict(seed=0, depth=2, width=8):
    """A synthetic CR-NeRF Lightning state dict: every prefix the
    converter maps (NeRF MLPs, encoder, StyleNet, CGNet), random values."""
    rng = np.random.default_rng(seed)
    sd = {}

    def lin(name, i, o):
        sd[f"{name}.weight"] = rng.normal(size=(o, i)).astype(np.float32)
        sd[f"{name}.bias"] = rng.normal(size=(o,)).astype(np.float32)

    def conv(name, i, o, k=3, bias=True):
        sd[f"{name}.weight"] = rng.normal(size=(o, i, k, k)).astype(
            np.float32)
        if bias:
            sd[f"{name}.bias"] = rng.normal(size=(o,)).astype(np.float32)

    def bn(name, c):
        for k in ("weight", "bias", "running_mean"):
            sd[f"{name}.{k}"] = rng.normal(size=(c,)).astype(np.float32)
        sd[f"{name}.running_var"] = rng.uniform(0.5, 2, c).astype(np.float32)

    for net in ("nerf_coarse", "nerf_fine"):
        for i in range(1, depth + 1):
            lin(f"{net}.xyz_encoding_{i}.0", width, width)
        lin(f"{net}.xyz_encoding_final", width, width)
        lin(f"{net}.static_sigma.0", width, 1)
        lin(f"{net}.dir_encoding.0", width + 3, width)
        lin(f"{net}.static_rgb.0", width, 4)
    for i in range(1, 8):
        conv(f"enc_a.conv{i}", 4, 4)
    for tower in ("cnet", "snet"):
        for j in (0, 2, 4):
            conv(f"decoder.multi_net.{tower}.convs.{j}", 4, 4)
        lin(f"decoder.multi_net.{tower}.fc", 4, 4)
    conv("decoder.multi_net.compress", 4, 4, k=1)
    conv("decoder.multi_net.unzip", 4, 4, k=1)
    conv("decoder.decoder.feat_2_rgb_list.0", 4, 3, k=1)
    for name in ("level1_0", "level1_1", "level1_2"):
        conv(f"implicit_mask.{name}.conv", 3, 3, bias=False)
        bn(f"implicit_mask.{name}.bn", 3)
        sd[f"implicit_mask.{name}.act.weight"] = rng.normal(size=(3,)).astype(
            np.float32)
    for name in ("b1", "bn_prelu_2", "bn_prelu_3"):
        bn(f"implicit_mask.{name}.bn", 3)
        sd[f"implicit_mask.{name}.act.weight"] = rng.normal(size=(3,)).astype(
            np.float32)
    for lvl in ("level2_0", "level3_0"):
        p = f"implicit_mask.{lvl}"
        conv(f"{p}.conv1x1.conv", 3, 3, k=1, bias=False)
        bn(f"{p}.conv1x1.bn", 3)
        sd[f"{p}.conv1x1.act.weight"] = rng.normal(size=(3,)).astype(
            np.float32)
        conv(f"{p}.F_loc.conv", 1, 3, bias=False)
        conv(f"{p}.F_sur.conv", 1, 3, bias=False)
        bn(f"{p}.bn", 6)
        sd[f"{p}.act.weight"] = rng.normal(size=(6,)).astype(np.float32)
        conv(f"{p}.reduce.conv", 6, 3, k=1, bias=False)
        lin(f"{p}.F_glo.fc.0", 3, 2)
        lin(f"{p}.F_glo.fc.2", 2, 3)
    conv("implicit_mask.classifier.0.conv", 3, 1, k=1, bias=False)
    sd["loss.dummy"] = np.zeros(1, np.float32)
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


def test_convert_state_dict_matches_jax():
    from crnerf_tpu.utils.torch_port import convert_state_dict as jconvert
    from crnerf_tpu_torch.utils.torch_port import convert_state_dict

    sd = _reference_state_dict()
    got = [_flat(t) for t in convert_state_dict(sd, netdepth=2)]
    want = [_flat(t) for t in jconvert(sd, netdepth=2)]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    with pytest.raises(ValueError, match="unknown checkpoint prefix"):
        convert_state_dict({"other.w": sd["loss.dummy"]})


def test_a_reference_checkpoint_loads_into_the_port(tmp_path):
    """A Lightning checkpoint of the port's own system under the
    reference's key names -> weights.npz -> a fresh system: every
    parameter comes back."""
    from crnerf_tpu_torch.render.system import CrNerfSystem
    from crnerf_tpu_torch.utils.torch_port import import_lightning_ckpt
    from crnerf_tpu_torch.utils.weights import load_into

    cfg = Config(netdepth=2, netwidth=32, nerf_out_dim=16, N_emb_xyz=10,
                 appearance_wh=(64, 48), encode_a=False, use_mask=False)
    torch.manual_seed(0)
    src = CrNerfSystem(cfg)
    sd = {}
    for net in ("nerf_coarse", "nerf_fine"):
        m = getattr(src, net)
        for name, ref in ([(f"xyz_encoding_{i}", f"xyz_encoding_{i}.0")
                           for i in range(1, 3)]
                          + [("xyz_encoding_final", "xyz_encoding_final"),
                             ("sigma", "static_sigma.0"),
                             ("dir_encoding", "dir_encoding.0"),
                             ("feature", "static_rgb.0")]):
            lin = getattr(m, name)
            sd[f"{net}.{ref}.weight"] = lin.weight.detach().clone()
            sd[f"{net}.{ref}.bias"] = lin.bias.detach().clone()
    for k, v in src.decoder.state_dict().items():   # the 1x1 conv to rgb
        sd[f"decoder.{k.replace('feat_2_rgb_', 'feat_2_rgb_list.')}"] = v
    ckpt = tmp_path / "ref.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    out = import_lightning_ckpt(str(ckpt), str(tmp_path / "weights.npz"),
                                netdepth=2)
    dst = load_into(CrNerfSystem(cfg), out).state_dict()
    assert dst.keys() == src.state_dict().keys()
    for k, v in src.state_dict().items():
        assert torch.equal(dst[k], v), k


def test_png_writer_and_depth_panel(tmp_path):
    from crnerf_tpu.utils.visualization import visualize_depth as jviz
    from crnerf_tpu_torch.utils.png import png_bytes, write_png
    from crnerf_tpu_torch.utils.visualization import visualize_depth

    rgb = np.random.default_rng(0).uniform(0, 1, (5, 7, 3)).astype(
        np.float32)
    write_png(str(tmp_path / "a.png"), rgb)
    got = _decode_png((tmp_path / "a.png").read_bytes())
    assert np.array_equal(got, (rgb * 255).astype(np.uint8))
    assert png_bytes(got) == (tmp_path / "a.png").read_bytes()
    d = np.linspace(0, 1, 12).reshape(3, 4)
    assert np.array_equal(visualize_depth(d), jviz(d))
    assert np.array_equal(visualize_depth(d.reshape(-1), wh=(4, 3)), jviz(d))


def test_metric_logger(tmp_path):
    from crnerf_tpu_torch.utils.logging import MetricLogger

    lg = MetricLogger(str(tmp_path), "exp")
    lg.log({"train/loss": torch.tensor(0.5), "lr": 1e-3, "note": "x"}, 10)
    lg.log_image("val/pred", np.zeros((3, 4, 3)), 10)
    lg.close()
    rows = [json.loads(x) for x in open(tmp_path / "exp" / "metrics.jsonl")]
    assert rows[0]["train/loss"] == 0.5 and rows[0]["step"] == 10
    assert rows[0]["note"] == "x"
    assert os.path.exists(tmp_path / "exp" / "images" /
                          "val_pred_00000010.png")
