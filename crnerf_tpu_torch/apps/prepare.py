"""Scene-cache builder (``crnerf_tpu/apps/prepare.py``): parse COLMAP and
decode the images once, and keep the Scene in one npz; training then starts
from the ray buffers. Needs PIL for the decode, so it runs where PIL is
installed; the cache it writes is the JAX package's layout. The work is
host work; ``--device`` defaults to ``cuda`` as in every app of the port,
and ``--device cpu`` runs it where there is no card.

Run:  python -m crnerf_tpu_torch prepare --root_dir SCENE --img_downscale 2
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

from crnerf_tpu_torch.apps import add_device_arg, resolve_device
from crnerf_tpu_torch.data.phototourism import (
    load_phototourism,
    save_scene_cache,
)


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(description="build a phototourism scene "
                                            "cache")
    p.add_argument("--root_dir", type=str, required=True)
    p.add_argument("--img_downscale", type=int, default=1)
    p.add_argument("--appearance_wh", nargs=2, type=int, default=[224, 160])
    add_device_arg(p)
    args = p.parse_args(argv)
    resolve_device(p, args.device)

    t0 = time.time()
    scene = load_phototourism(args.root_dir,
                              img_downscale=args.img_downscale,
                              appearance_wh=tuple(args.appearance_wh),
                              use_cache=False)
    path = save_scene_cache(scene, root_dir=args.root_dir,
                            img_downscale=args.img_downscale)
    print(f"cached {scene.name}: {len(scene.train_images)} train / "
          f"{len(scene.test_images)} test images -> {path} "
          f"({time.time() - t0:.1f}s)")
    return path


if __name__ == "__main__":
    main()
