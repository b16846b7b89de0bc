"""Command-line apps of the port: ``prepare``, ``train``, ``eval``,
``metrics``, ``video`` and ``serve`` (``python -m crnerf_tpu_torch <cmd>``),
and the dataset registry they share."""

from __future__ import annotations

import argparse
from typing import Callable

import torch

from crnerf_tpu_torch.parallel import mesh


def load_scene_from_config(cfg, split: str = "train"):
    """The Config's dataset as a Scene (``crnerf_tpu/apps/__init__.py``
    ``load_scene_from_config``): ``phototourism`` (the cache when there is
    one, else the raw scene), ``blender`` (its ``split``'s transforms, the
    train split perturbed by ``data_perturb``) or ``synthetic``."""
    if cfg.dataset_name == "phototourism":
        from crnerf_tpu_torch.data.phototourism import load_phototourism

        return load_phototourism(cfg.root_dir,
                                 img_downscale=cfg.img_downscale,
                                 appearance_wh=tuple(cfg.appearance_wh),
                                 use_cache=cfg.use_cache)
    if cfg.dataset_name == "synthetic":
        from crnerf_tpu_torch.data.synthetic import make_synthetic_scene

        return make_synthetic_scene(appearance_wh=tuple(cfg.appearance_wh))
    if cfg.dataset_name == "blender":
        from crnerf_tpu_torch.data.blender import load_blender

        return load_blender(cfg.root_dir, split=split,
                            img_wh=tuple(cfg.img_wh),
                            perturbation=tuple(cfg.data_perturb),
                            appearance_wh=tuple(cfg.appearance_wh))
    raise ValueError(f"unknown dataset {cfg.dataset_name!r}")


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain "
                        "versions and must be asked for")


def resolve_device(p: argparse.ArgumentParser, name: str) -> torch.device:
    """``--device`` as a torch device; stops the app (``p.error``) when it
    names a card and none is present."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        p.error(f"--device {name}: no CUDA device is available (pass "
                "--device cpu to run on the CPU)")
    return device


def run_ranks(fn: Callable, num_devices: int, device: torch.device, *args):
    """Run ``fn(*args, device, group)``: under a launcher (``torchrun``) as
    this process's rank of its group; with ``num_devices`` (0: every
    visible GPU) above 1 on that many ranks spawned here, one device each
    (returns None); else in this process with no group. ``fn`` is a
    module-level function (the spawned ranks import it)."""
    n = mesh.resolve_world(num_devices, device)
    if mesh.launched():
        return _rank_main(fn, device, args)
    if n > 1:
        mesh.spawn(_rank_main, n, (fn, device, args))
        return None
    return fn(*args, device, None)


def _rank_main(fn: Callable, device, args):
    import torch.distributed as dist

    device, group = mesh.init_distributed(device)
    try:
        return fn(*args, device, group)
    finally:
        dist.destroy_process_group()
