"""Render a dataset split to PNGs (``crnerf_tpu/apps/eval.py``).

Splits:
- ``test_test``: every test image at its own size with its own appearance;
- ``test_train``: the same over the train images;
- ``val``: the first train image;
- ``test``: the scene preset's camera path (``render/camera_path.py``) at
  ``img_wh``, fov 60, in the appearance of one train image (the preset's
  ``appearance_train_idx``, clamped), around the preset's pose anchor (the
  style image where the scene lacks it); ``--num_frames`` overrides the
  preset's 240 frames. PNGs, then ``<scene_name>.gif`` (``--video_format``).

``--ckpt_path`` is a ``weights.npz`` inference bundle or a training
checkpoint directory that holds one. Frames are kept ``eval_pipeline`` deep
in flight (``Renderer.render_frame_cam_async``, or with ``--no-cam_rays``
``render_frame_async`` from host rays) and come back as uint8, quantized on
the device, written by the standard-library PNG writer. The log line gives
the median and p95 of the segments between successive PNG completions
(they sum to the wall time, the first holding the kernels' first launches).
With ``--num_devices N`` (or under ``torchrun``) every frame's rays are
split over N ranks (``Renderer(group=)``) and rank 0 writes the PNGs, the
GIF and the log line.

Run:  python -m crnerf_tpu_torch eval --split test_test --ckpt_path DIR \\
          --dataset_name phototourism --root_dir SCENE [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from crnerf_tpu_torch.apps import (
    add_device_arg,
    load_scene_from_config,
    resolve_device,
    run_ranks,
)
from crnerf_tpu_torch.apps.serve import load_system
from crnerf_tpu_torch.config import Config, build_parser, config_from_args
from crnerf_tpu_torch.data.pipeline import full_image_batch
from crnerf_tpu_torch.parallel import mesh
from crnerf_tpu_torch.render import camera_path
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.utils.png import write_png
from crnerf_tpu_torch.utils.visualization import write_video

SPLITS = ("test_test", "test_train", "val", "test")


def render_frames(renderer: Renderer, dispatches, out_dir: str,
                  depth: int, write: bool = True
                  ) -> Tuple[Dict[int, np.ndarray], List[float]]:
    """Frames ``depth`` deep in flight: ``dispatches`` yields (index,
    handle); each fetched u8 frame is written as ``NNN.png`` (unless
    ``write`` is False: a rank other than 0). -> (frames by index, the
    segments in s between successive PNG completions, which sum to the
    wall time)."""
    pending: list = []   # (index, handle) in dispatch order
    frames, done_t = {}, []
    t_all = time.perf_counter()

    def _drain_one():
        i, hnd = pending.pop(0)
        frames[i] = renderer.fetch(hnd)["rgb_u8"]
        if write:
            write_png(os.path.join(out_dir, f"{i:03d}.png"), frames[i])
        done_t.append(time.perf_counter())

    for item in dispatches:
        pending.append(item)
        while len(pending) >= depth:
            _drain_one()
    while pending:
        _drain_one()
    return frames, list(np.diff(np.asarray([t_all] + done_t)))


def segment_line(seg: List[float], depth: int) -> str:
    return (f"median {float(np.median(seg)):.3f} / p95 "
            f"{float(np.percentile(seg, 95)):.3f} s/frame (segments between "
            f"PNG completions; wall {float(np.sum(seg)):.2f} s pipelined "
            f"x{depth})")


def path_anchors(scene, spec: camera_path.PathSpec):
    """-> (style image, pose anchor image) of a preset on a scene: the
    preset's appearance source (clamped to the train images), and its pose
    anchor by image id or train index where the scene has it, else the
    style image."""
    train_imgs = scene.train_images
    style = train_imgs[min(spec.appearance_train_idx or 0,
                           len(train_imgs) - 1)]
    anchor = style
    if spec.pose_image_id is not None:
        anchor = next((im for im in train_imgs
                       if im.id == spec.pose_image_id), style)
    elif (spec.pose_train_idx is not None
          and spec.pose_train_idx < len(train_imgs)):
        anchor = train_imgs[spec.pose_train_idx]
    return style, anchor


def path_dispatches(renderer: Renderer, cfg: Config, spec, anchor_c2w,
                    near: float, far: float, style: np.ndarray):
    """(index, handle) of each frame of a camera path, style (1, Ha, Wa, 3)
    in [-1, 1]: camera in with the style staged once on the device, or
    with ``--no-cam_rays`` host rays (``test_path_rays``)."""
    w, h = tuple(cfg.img_wh)
    if cfg.cam_rays:
        style_dev = torch.as_tensor(np.asarray(style, np.float32),
                                    device=renderer.device)
        K = camera_path.fov_intrinsics((w, h))
        for i, c2w in enumerate(spec.poses(anchor_c2w)):
            yield i, renderer.render_frame_cam_async(
                c2w, K, near, far, (h, w), style_dev, outputs="rgb_u8")
    else:
        for i, rays in enumerate(camera_path.test_path_rays(
                spec, anchor_c2w, (w, h), near, far)):
            yield i, renderer.render_frame_async(rays, style, (h, w),
                                                 outputs="rgb_u8")


def run(cfg: Config, device: torch.device, group=None) -> str:
    """Render the split on ``device``, as one rank of ``group`` when there
    is one (rank 0 writes and prints)."""
    if cfg.split not in SPLITS:
        raise ValueError(f"unsupported split {cfg.split!r} (one of "
                         f"{SPLITS})")
    if not cfg.ckpt_path:
        raise ValueError("--ckpt_path is required: weights.npz or a "
                         "training checkpoint directory holding one")
    renderer = Renderer(cfg, load_system(cfg, cfg.ckpt_path, device), device,
                        group=group)
    scene = load_scene_from_config(cfg, cfg.split)
    out_dir = os.path.join(cfg.save_dir, "results", cfg.dataset_name,
                           cfg.scene_name)
    lead = mesh.rank(group) == 0
    if lead:
        os.makedirs(out_dir, exist_ok=True)
    depth = max(1, cfg.eval_pipeline)

    if cfg.split == "test":
        spec = camera_path.PATH_PRESETS[camera_path.resolve_scene(
            cfg.scene_name)]
        if cfg.num_frames > 0:
            spec = dataclasses.replace(spec, n_frames=cfg.num_frames)
        style, anchor = path_anchors(scene, spec)
        frames, seg = render_frames(
            renderer, path_dispatches(
                renderer, cfg, spec, anchor.c2w, anchor.near, anchor.far,
                style.appearance[None].astype(np.float32)),
            out_dir, depth, write=lead)
        if lead:
            video = write_video(os.path.join(out_dir, cfg.scene_name),
                                [frames[i] for i in sorted(frames)],
                                fmt=cfg.video_format)
            print(f"rendered {len(frames)}-frame path -> {out_dir}, {video} "
                  f"| {segment_line(seg, depth)}", flush=True)
        return out_dir

    images = (scene.test_images if cfg.split == "test_test"
              else scene.train_images)
    if cfg.split == "val":
        images = images[:1]

    def dispatches():
        for i, im in enumerate(images):
            w, h = im.wh
            style = im.appearance[None].astype(np.float32)
            if cfg.cam_rays:
                yield i, renderer.render_frame_cam_async(
                    im.c2w, im.K, im.near, im.far, (h, w), style,
                    outputs="rgb_u8")
            else:
                b = full_image_batch(scene, im)
                yield i, renderer.render_frame_async(
                    b["rays"], style, (h, w), outputs="rgb_u8")

    _, seg = render_frames(renderer, dispatches(), out_dir, depth,
                           write=lead)
    if not lead:
        return out_dir
    if not seg:
        print(f"rendered 0 images -> {out_dir} (split {cfg.split!r} is "
              "empty)", flush=True)
        return out_dir
    print(f"rendered {len(images)} images -> {out_dir} | "
          f"{segment_line(seg, depth)}", flush=True)
    return out_dir


def main(argv: Optional[Sequence[str]] = None):
    p = build_parser()
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)
    cfg = config_from_args(args)
    return run_ranks(run, cfg.num_devices, device, cfg)


if __name__ == "__main__":
    main()
