"""Render a dataset split to PNGs (``crnerf_tpu/apps/eval.py``).

Splits:
- ``test_test``: every test image at its own size with its own appearance;
- ``test_train``: the same over the train images;
- ``val``: the first train image.

The camera-path ``test`` split (frames and a video) is not ported yet:
``python -m crnerf_tpu eval --split test`` renders it.

``--ckpt_path`` is a ``weights.npz`` inference bundle or a training
checkpoint directory that holds one. Frames are kept ``eval_pipeline`` deep
in flight (``Renderer.render_frame_cam_async``, or with ``--no-cam_rays``
``render_frame_async`` from host rays) and come back as uint8, quantized on
the device, written by the standard-library PNG writer. The log line gives
the median and p95 of the segments between successive PNG completions
(they sum to the wall time, the first holding the kernels' first launches).

Run:  python -m crnerf_tpu_torch eval --split test_test --ckpt_path DIR \\
          --dataset_name phototourism --root_dir SCENE [--device cpu]
"""

from __future__ import annotations

import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from crnerf_tpu_torch.apps import (
    add_device_arg,
    load_scene_from_config,
    resolve_device,
)
from crnerf_tpu_torch.apps.serve import load_system
from crnerf_tpu_torch.config import Config, build_parser, config_from_args
from crnerf_tpu_torch.data.pipeline import full_image_batch
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.utils.png import write_png

SPLITS = ("test_test", "test_train", "val")


def run(cfg: Config, device: torch.device) -> str:
    if cfg.split == "test":
        raise NotImplementedError(
            "the camera-path split 'test' is not ported yet (python -m "
            "crnerf_tpu eval --split test renders it)")
    if cfg.split not in SPLITS:
        raise ValueError(f"unsupported split {cfg.split!r} (one of "
                         f"{SPLITS})")
    if not cfg.ckpt_path:
        raise ValueError("--ckpt_path is required: weights.npz or a "
                         "training checkpoint directory holding one")
    renderer = Renderer(cfg, load_system(cfg, cfg.ckpt_path, device), device)
    scene = load_scene_from_config(cfg)
    out_dir = os.path.join(cfg.save_dir, "results", cfg.dataset_name,
                           cfg.scene_name)
    os.makedirs(out_dir, exist_ok=True)
    images = (scene.test_images if cfg.split == "test_test"
              else scene.train_images)
    if cfg.split == "val":
        images = images[:1]

    depth = max(1, cfg.eval_pipeline)
    pending: list = []   # (index, handle) in dispatch order
    done_t = []          # completion stamps, PNG written
    t_all = time.perf_counter()

    def _drain_one():
        i, hnd = pending.pop(0)
        write_png(os.path.join(out_dir, f"{i:03d}.png"),
                  renderer.fetch(hnd)["rgb_u8"])
        done_t.append(time.perf_counter())

    for i, im in enumerate(images):
        w, h = im.wh
        style = im.appearance[None].astype(np.float32)
        if cfg.cam_rays:
            hnd = renderer.render_frame_cam_async(
                im.c2w, im.K, im.near, im.far, (h, w), style,
                outputs="rgb_u8")
        else:
            b = full_image_batch(scene, im)
            hnd = renderer.render_frame_async(b["rays"], style, (h, w),
                                              outputs="rgb_u8")
        pending.append((i, hnd))
        while len(pending) >= depth:
            _drain_one()
    while pending:
        _drain_one()
    wall = time.perf_counter() - t_all
    if not done_t:
        print(f"rendered 0 images -> {out_dir} (split {cfg.split!r} is "
              "empty)", flush=True)
        return out_dir
    seg = np.diff(np.asarray([t_all] + done_t))
    print(f"rendered {len(images)} images -> {out_dir} | median "
          f"{float(np.median(seg)):.3f} / p95 "
          f"{float(np.percentile(seg, 95)):.3f} s/frame (segments between "
          f"PNG completions; wall {wall:.2f} s pipelined x{depth})",
          flush=True)
    return out_dir


def main(argv: Optional[Sequence[str]] = None):
    p = build_parser()
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)
    return run(config_from_args(args), device)


if __name__ == "__main__":
    main()
