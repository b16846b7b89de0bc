"""Score saved renders against the ground truth
(``crnerf_tpu/apps/eval_metric.py``).

The protocol: PSNR, SSIM (window 3), MSE and LPIPS-alex on the RIGHT HALF
of each image (``[:, w // 2:]``; the left half was seen through the
appearance encoder in training), averaged over the split and appended as
one line to ``result.txt`` in the render directory. The renders are the
eval app's ``NNN.png``, read without an image library; a missing one fails
the run. LPIPS needs its weights file (``eval/lpips.py``); where it is
absent the app says so and reports the other three, as the JAX package
does.

Run:  python -m crnerf_tpu_torch metrics --root_dir SCENE \\
          --dataset_name phototourism --scene_name NAME --save_dir DIR \\
          [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from crnerf_tpu_torch.apps import (
    add_device_arg,
    load_scene_from_config,
    resolve_device,
)
from crnerf_tpu_torch.config import Config
from crnerf_tpu_torch.eval.lpips import LpipsAlex
from crnerf_tpu_torch.train.metrics import mse, psnr, ssim
from crnerf_tpu_torch.utils.png import read_png


def score_pair(pred01: np.ndarray, gt01: np.ndarray,
               device: torch.device = torch.device("cpu"), lpips_fn=None):
    """pred / gt (h, w, 3) float [0, 1] -> psnr, ssim, mse (and with
    ``lpips_fn`` lpips) of the right half."""
    w = pred01.shape[1]
    pred = torch.as_tensor(np.ascontiguousarray(pred01[:, w // 2:]),
                           dtype=torch.float32, device=device)
    gt = torch.as_tensor(np.ascontiguousarray(gt01[:, w // 2:]),
                         dtype=torch.float32, device=device)
    out = {"psnr": float(psnr(pred, gt)), "ssim": float(ssim(pred, gt)),
           "mse": float(mse(pred, gt))}
    if lpips_fn is not None:
        out["lpips"] = lpips_fn(pred, gt)
    return out


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="score saved renders")
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--dataset_name", type=str, default="phototourism")
    p.add_argument("--scene_name", type=str, default="scene")
    p.add_argument("--save_dir", type=str, default="./results")
    p.add_argument("--img_downscale", type=int, default=2)
    p.add_argument("--img_wh", nargs=2, type=int,
                   default=list(Config.img_wh),
                   help="blender: the size the renders were made at")
    p.add_argument("--split", type=str, default="test_test")
    add_device_arg(p)
    args = p.parse_args(argv)
    device = resolve_device(p, args.device)

    cfg = Config(root_dir=args.root_dir, dataset_name=args.dataset_name,
                 scene_name=args.scene_name,
                 img_downscale=args.img_downscale,
                 img_wh=tuple(args.img_wh), split=args.split)
    scene = load_scene_from_config(cfg, args.split)
    images = (scene.test_images if args.split == "test_test"
              else scene.train_images)
    render_dir = os.path.join(args.save_dir, "results", args.dataset_name,
                              args.scene_name)
    lpips_fn = None
    try:
        lpips_fn = LpipsAlex(device=device)
    except FileNotFoundError as e:   # no weights file
        print(f"lpips unavailable ({e}); reporting psnr/ssim/mse only",
              flush=True)

    rows, missing = [], []
    for i, im in enumerate(images):
        path = os.path.join(render_dir, f"{i:03d}.png")
        if not os.path.exists(path):
            missing.append(os.path.basename(path))
            continue
        pred = read_png(path, "RGB").astype(np.float32) / 255.0
        w, h = im.wh
        rows.append(score_pair(pred, im.rgbs.reshape(h, w, 3), device,
                               lpips_fn))
    if missing:
        # a half-finished render directory must not score as a healthy
        # mean
        raise FileNotFoundError(
            f"{render_dir}: expected {len(images)} renders, found "
            f"{len(rows)}; missing {missing[:10]}"
            + ("..." if len(missing) > 10 else ""))
    if not rows:
        raise FileNotFoundError(f"no renders found under {render_dir}")
    mean = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    line = (f"{args.scene_name} n={len(rows)} "
            + " ".join(f"{k}={v:.4f}" for k, v in mean.items()))
    print(line, flush=True)
    with open(os.path.join(render_dir, "result.txt"), "a") as f:
        f.write(line + "\n")
    return mean


if __name__ == "__main__":
    main()
