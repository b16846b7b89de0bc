"""Appearance-hallucination video (``crnerf_tpu/apps/video.py``): for each
style image in a folder, sorted, render the scene preset's camera path
around its built-in anchor pose (``DEMO_ANCHORS``: the demo needs no
COLMAP data) in that image's appearance, and write the frames as PNGs and
a 30 fps GIF (``--video_format mp4`` writes the GIF with a warning).

near/far are the demo's 0/5 and sampling its 256 + 256; the decode is
style only (no mask, no random embedding). Frames are kept
``eval_pipeline`` deep in flight, camera in, with the style staged once on
the device (``apps/eval.py`` ``path_dispatches``). Style images: a PNG is
decoded and Lanczos-resized without an image library; another format
needs PIL. With ``--num_devices N`` (or under ``torchrun``) every frame's
rays are split over N ranks and rank 0 writes the PNGs and the GIFs.

Run:  python -m crnerf_tpu_torch video --ckpt_path weights.npz \\
          --scene_name brandenburg_gate --style_dir STYLES [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
from typing import Optional, Sequence

from crnerf_tpu_torch.apps import (
    add_device_arg,
    resolve_device,
    run_ranks,
)
from crnerf_tpu_torch.apps.eval import (
    path_dispatches,
    render_frames,
    segment_line,
)
from crnerf_tpu_torch.apps.serve import load_style, load_system
from crnerf_tpu_torch.config import Config
from crnerf_tpu_torch.parallel import mesh
from crnerf_tpu_torch.render.camera_path import (
    DEMO_ANCHORS,
    PATH_PRESETS,
    resolve_scene,
)
from crnerf_tpu_torch.render.inference import Renderer
from crnerf_tpu_torch.utils.visualization import write_video


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="appearance-hallucination video")
    p.add_argument("--ckpt_path", type=str, required=True)
    p.add_argument("--scene_name", type=str, required=True)
    p.add_argument("--style_dir", type=str, required=True,
                   help="folder of style images (reference images/artworks)")
    p.add_argument("--save_dir", type=str, default="./results")
    p.add_argument("--img_wh", nargs=2, type=int, default=[320, 240])
    p.add_argument("--N_samples", type=int, default=256)
    p.add_argument("--N_importance", type=int, default=256)
    p.add_argument("--chunk", type=int, default=8192)
    p.add_argument("--n_frames", type=int, default=240)
    # architecture knobs must match the checkpoint
    p.add_argument("--netdepth", type=int, default=8)
    p.add_argument("--netwidth", type=int, default=256)
    p.add_argument("--nerf_out_dim", type=int, default=64)
    p.add_argument("--appearance_wh", nargs=2, type=int,
                   default=[224, 160])
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=("bfloat16", "float32"))
    p.add_argument("--video_format", choices=["gif", "mp4"], default="gif")
    p.add_argument("--num_devices", type=int, default=0,
                   help="ranks of one GPU each (0 = every visible GPU with "
                        "--device cuda, 1 on the cpu)")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)
    return run_ranks(run, args.num_devices, device, args)


def run(args: argparse.Namespace, device, group=None):
    """The videos of ``main``'s arguments on ``device``, as one rank of
    ``group`` when there is one (rank 0 writes and prints)."""

    cfg = Config(
        scene_name=args.scene_name, N_samples=args.N_samples,
        N_importance=args.N_importance, chunk=args.chunk,
        img_wh=tuple(args.img_wh), appearance_wh=tuple(args.appearance_wh),
        netdepth=args.netdepth, netwidth=args.netwidth,
        nerf_out_dim=args.nerf_out_dim, compute_dtype=args.compute_dtype,
        use_mask=False, encode_random=False,
    )
    scene_key = resolve_scene(args.scene_name)
    anchor = DEMO_ANCHORS.get(scene_key)
    if anchor is None:
        raise KeyError(f"no demo anchor pose for {scene_key}")
    spec = dataclasses.replace(PATH_PRESETS[scene_key],
                               n_frames=args.n_frames)
    renderer = Renderer(cfg, load_system(cfg, args.ckpt_path, device),
                        device, group=group)
    lead = mesh.rank(group) == 0
    depth = max(1, cfg.eval_pipeline)
    outs = []
    for style_path in sorted(glob.glob(os.path.join(args.style_dir, "*"))):
        name = os.path.splitext(os.path.basename(style_path))[0]
        out_dir = os.path.join(args.save_dir, "video", args.scene_name, name)
        if lead:
            os.makedirs(out_dir, exist_ok=True)
        style = load_style(style_path, args.appearance_wh)
        frames, seg = render_frames(
            renderer, path_dispatches(renderer, cfg, spec, anchor, 0.0, 5.0,
                                      style),
            out_dir, depth, write=lead)
        if lead:
            video = write_video(os.path.join(out_dir, name),
                                [frames[i] for i in sorted(frames)],
                                fmt=args.video_format)
            print(f"{name}: {len(frames)} frames -> {out_dir}, {video} | "
                  f"{segment_line(seg, depth)}", flush=True)
        outs.append(out_dir)
    return outs


if __name__ == "__main__":
    main()
