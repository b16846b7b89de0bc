"""The port imports torch and never jax, flax, optax or the JAX package:
every module of crnerf_tpu_torch (the train/ and data/ packages, the
trainer, the checkpoints and the apps, the conv, sincos, pipelined-render
and sublane-stores ops, the spike tools, parallel/mesh.py, LPIPS and the
model zoo's tail included), and chip_smoke.py, import with all four
blocked. Its Config keeps the JAX
Config's names and defaults. Its entry points (prepare, train, eval,
metrics, video, serve, the spike tools) run on the card unless the caller
asks for the CPU."""

import dataclasses
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = """
import importlib, pkgutil, sys
for blocked in ("jax", "flax", "optax", "crnerf_tpu"):
    sys.modules[blocked] = None
import crnerf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(crnerf_tpu_torch.__path__,
                                               "crnerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for needed in ("train.step", "train.losses", "train.optim", "train.state",
               "train.metrics", "data.pipeline", "data.sampler",
               "data.scene", "data.synthetic", "ops.composite",
               "ops.fused_render", "ops.fused_mlp", "tools.slab_ab",
               "ops.conv", "ops.sincos", "tools.spike_conv3x3",
               "tools.spike_packed_conv", "tools.spike_kernel_sincos",
               "ops.pipe_render", "ops.sublane_stores",
               "tools.spike_interleave", "tools.spike_sublane_stores",
               "tools.tf32_ab", "tools.draw_spread", "train.loop",
               "data.phototourism", "data.colmap", "data.pfm",
               "apps.prepare", "apps.train", "apps.eval",
               "utils.checkpoint", "utils.logging", "utils.png",
               "utils.torch_port", "utils.lanczos", "utils.visualization",
               "render.camera_path", "data.blender", "apps.eval_metric",
               "apps.video", "tools.codec_times", "parallel.mesh",
               "eval.lpips", "models.esrgan", "models.networks"):
    assert "crnerf_tpu_torch." + needed in names, needed
import chip_smoke
chip_smoke.serve_config()
chip_smoke.train_config()
assert not any(k in ("jax", "crnerf_tpu", "optax")
               or k.startswith(("jax.", "flax", "optax.", "crnerf_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _CODE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 30


def test_config_fields_match_the_jax_config():
    """Every field of the port's Config is a JAX Config field with the same
    default, and the derived channel counts agree."""
    from crnerf_tpu.config import Config as JaxConfig
    from crnerf_tpu_torch.config import Config

    jax_defaults = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    names = {f.name for f in dataclasses.fields(Config)}
    for f in dataclasses.fields(Config):
        assert f.name in jax_defaults, f.name
        assert f.default == jax_defaults[f.name], f.name
    # the fields the training step reads
    assert names >= {
        "perturb", "noise_std", "encode_c", "encode_random",
        "mse_on_appearance", "N_vocab", "maskrs_max", "maskrs_min",
        "maskrs_k", "maskrd", "weightKL", "weightRecA", "weightMS",
        "weightcontent", "batch_size", "grids_per_step", "num_epochs",
        "optimizer", "lr", "momentum", "weight_decay", "lr_scheduler",
        "warmup_multiplier", "warmup_epochs", "decay_step", "decay_gamma",
        "poly_exp", "grad_accum_chunks", "seed"}
    # the fields the data, the trainer and the apps read
    assert names >= {
        "root_dir", "dataset_name", "scene_name", "split", "img_downscale",
        "img_wh", "use_cache", "testit", "scale_anneal", "min_scale",
        "save_dir", "ckpt_path", "auto_resume", "prefixes_to_ignore",
        "exp_name", "proj_name", "log_every", "use_wandb",
        "ckpt_every_epochs", "val_every_epochs", "val_chunk", "cam_rays",
        "eval_pipeline"}
    assert "device" not in names
    # the fields that select a route, each between routes that exist here
    # too: the no-stash training routes, kernels or the module, the fused
    # render or the fused MLP + composite
    routing = {"pertube_cord": False, "pallas_stash": True,
               "use_pallas": True, "pallas_train": True,
               "pallas_render": True, "remat": True}
    assert set(routing) <= names
    for name, default in routing.items():
        assert getattr(Config(), name) is default, name
        assert getattr(JaxConfig(), name) is default, name
    # no TPU-only knob came along
    assert not any((n.startswith(("pallas_", "s2d_", "slab_"))
                    and n not in routing)
                   or n in ("fold_heads", "hoist_heads", "pdf_impl",
                            "chunk_unroll", "eval_tile_pts")
                   for n in names)
    assert Config(batch_size=256).grid_hw == JaxConfig(batch_size=256).grid_hw
    kw = dict(N_emb_xyz=10, N_emb_dir=3)
    assert Config(**kw).in_channels_xyz == JaxConfig(**kw).in_channels_xyz
    assert Config(**kw).in_channels_dir == JaxConfig(**kw).in_channels_dir


def test_chip_smoke_refuses_without_a_card():
    """No CUDA device: exit non-zero and print no result line."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_serve_cli_defaults_to_the_card_and_fails_without_one(tmp_path):
    """``--device`` defaults to "cuda"; with no CUDA device the server
    stops at start with a message that names the way to the CPU, before it
    looks for the checkpoint. ``--device cpu`` gets past that point (and
    then fails on the missing checkpoint)."""
    import inspect

    import crnerf_tpu_torch.apps as apps
    from crnerf_tpu_torch.apps import serve

    src = inspect.getsource(serve.main)
    assert "add_device_arg(p)" in src and "resolve_device(p" in src
    assert '"--device", type=str, default="cuda"' in inspect.getsource(
        apps.add_device_arg)
    assert "is_available() else" not in inspect.getsource(serve)
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "crnerf_tpu_torch", "serve", "--ckpt_path",
            str(tmp_path / "missing.npz")]
    out = subprocess.run(base, cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert "serving on" not in out.stdout
    out = subprocess.run(base + ["--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no weights.npz" in out.stderr
    assert "no CUDA device" not in out.stderr


def test_config_cli_matches_the_jax_cli():
    """build_parser / get_config: paired boolean switches, tuples,
    --testit forcing one epoch, the JSON round trip."""
    from crnerf_tpu.config import get_config as jax_get_config
    from crnerf_tpu_torch.config import Config, get_config

    argv = ["--batch_size", "256", "--no-use_mask", "--lr", "1e-3",
            "--decay_step", "5", "10", "--auto_resume", "--ckpt_path", "d",
            "--appearance_wh", "32", "24", "--testit", "--exp_name", "x"]
    cfg, jcfg = get_config(argv), jax_get_config(argv)
    for f in dataclasses.fields(Config):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.num_epochs == 1 and cfg.decay_step == (5, 10)
    assert Config.from_json(cfg.to_json()) == cfg
    assert Config.from_json(jcfg.to_json()) == cfg


@pytest.mark.parametrize("cmd,extra,later", [
    ("prepare", ["--root_dir", "missing"], "tsv"),
    ("train", ["--root_dir", "missing"], "tsv"),
    ("eval", ["--root_dir", "missing", "--ckpt_path", "missing.npz"],
     "no weights.npz"),
    ("metrics", ["--root_dir", "missing"], "tsv"),
    ("video", ["--ckpt_path", "missing.npz", "--scene_name",
               "x_brandenburg_gate", "--style_dir", "missing"],
     "no weights.npz"),
])
def test_cli_apps_default_to_the_card_and_fail_without_one(cmd, extra,
                                                           later):
    """``--device`` defaults to "cuda" (or is "cuda"); with no CUDA device
    the app stops at start with a message that names the way to the CPU,
    before it reads anything. ``--device cpu`` gets past that point (and
    then fails on the missing input)."""
    import inspect

    import crnerf_tpu_torch.apps as apps
    from importlib import import_module

    assert '"--device", type=str, default="cuda"' in inspect.getsource(
        apps.add_device_arg)
    from crnerf_tpu_torch.__main__ import COMMANDS

    src = inspect.getsource(import_module(COMMANDS[cmd]))
    assert "add_device_arg(" in src and "resolve_device(" in src
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    base = [sys.executable, "-m", "crnerf_tpu_torch", cmd, *extra]
    for dev in ([], ["--device", "cuda"]):
        out = subprocess.run(base + dev, cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
        assert out.stdout == ""
    out = subprocess.run(base + ["--device", "cpu"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert later in out.stderr and "no CUDA device" not in out.stderr


def test_no_entry_point_picks_the_cpu_by_itself():
    """No module of the port chooses its device by whether a card is
    present: the tools refuse without one, the server defaults to cuda."""
    import pathlib

    for path in pathlib.Path(REPO, "crnerf_tpu_torch").rglob("*.py"):
        text = path.read_text()
        assert "is_available() else" not in text, path



SPIKE_TOOLS = ("spike_conv3x3", "spike_packed_conv", "spike_kernel_sincos",
               "spike_interleave", "spike_sublane_stores")


@pytest.mark.parametrize("tool", SPIKE_TOOLS)
def test_spike_tool_stops_without_a_card(tool):
    """No CUDA device and no ``--device``: the tool stops at start with a
    message that names the way to the CPU, and prints no result."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", f"crnerf_tpu_torch.tools.{tool}"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("check", ["recompute", "slabs"])
def test_draw_spread_stops_without_a_card(check):
    """The check-spread tool measures on the card only: without one it
    stops at start and prints no result."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "crnerf_tpu_torch.tools.draw_spread", check],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "needs a CUDA device" in out.stderr
    assert out.stdout == ""


@pytest.mark.parametrize("tool,argv", [
    ("spike_conv3x3", ["--n", "1", "--h", "6", "--w", "10", "--c", "8",
                       "--co", "16", "--check"]),
    ("spike_conv3x3", ["--n", "1", "--h", "5", "--w", "7", "--c", "3",
                       "--co", "5"]),
    ("spike_packed_conv", ["--iters", "1"]),
    ("spike_kernel_sincos", []),
    ("spike_interleave", ["--rays", "3", "--s", "20"]),
    ("spike_sublane_stores", ["--tiles", "2", "--iters", "1"]),
])
def test_spike_tool_runs_on_the_cpu_when_asked(monkeypatch, capsys, tool,
                                               argv):
    """``--device cpu``: the plain versions, PyTorch's CPU convolution in
    cuDNN's place, the JAX scripts' output lines (the packed spike at a
    small level shape: its own two levels are minutes of CPU)."""
    import importlib

    mod = importlib.import_module(f"crnerf_tpu_torch.tools.{tool}")
    if tool == "spike_packed_conv":
        monkeypatch.setattr(mod, "CASES", (("small", (1, 8, 12, 8), 8),))
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("device: CPU")
    want = {"spike_conv3x3": "checks OK" if "--check" in argv else
            "kernel dw ",
            "spike_packed_conv": "small: max rel err vs library = ",
            "spike_kernel_sincos": "torch sin vs f64 numpy @1280 rad",
            "spike_interleave": "pipelined P=4 at (3 x 20): max|d| vs K1 "
                                "0.00e+00 (same bits)",
            "spike_sublane_stores": "cuBLAS: none on the CPU"}[tool]
    assert want in out


def test_train_with_the_reference_flags_refuses_without_a_card(tmp_path):
    """The reference's own training flags (the content heads, Ranger) take
    the same way as every entry point: no CUDA device, no run, and a
    message that names the way to the CPU."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "crnerf_tpu_torch", "train", "--encode_a",
         "--encode_c", "--encode_random", "--use_mask", "--optimizer",
         "ranger", "--dataset_name", "synthetic", "--save_dir",
         str(tmp_path)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "--device cpu" in out.stderr
    assert not (tmp_path / "ckpts").exists()
