"""Phototourism (IMC-PT) scene loader -> ``Scene``
(``crnerf_tpu/data/phototourism.py``; numpy, with PIL for the image decode
only).

- ``{scene}.tsv`` lists images and their train/test split; rows whose id is
  null are dropped; the tsv's id column is otherwise ignored (the COLMAP id
  comes from images.bin by file name). The tsv is read with ``csv``; a null
  is one of pandas' default missing-value strings, as the JAX loader reads
  it.
- Intrinsics from cameras.bin as PINHOLE-style params (fx, fy, cx, cy); the
  nominal image size is (2 cx, 2 cy), and focal and centre are rescaled by
  the integer-floor downscale.
- Poses: the COLMAP w2c (qvec, tvec) inverted to c2w, the rotation re-based
  from right-down-front to right-up-back by negating columns 1:3.
- Per-image near/far: the 0.1 / 99.9 percentiles of the depth of the world
  points in front of the camera; one global scale maps the largest far to 5.
- Images are decoded at ``img_downscale`` (Lanczos); the appearance input
  is resized to one fixed (Wa, Ha) in [-1, 1].

``save_scene_cache`` / ``load_scene_cache`` keep a loaded scene in one npz,
``<root_dir>/cache_tpu/scene_ds{N}.npz``, in the JAX package's layout: a
cache either package wrote trains the other. The image decode needs PIL;
where it is missing (the GPU machine), train from a cache made where it is
(``python -m crnerf_tpu_torch prepare``).
"""

from __future__ import annotations

import csv
import glob
import os
from typing import Dict, Optional, Tuple

import numpy as np

from crnerf_tpu_torch.data import colmap
from crnerf_tpu_torch.data.scene import Scene, SceneImage

# pandas.read_csv's default missing values
_NULLS = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
          "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN",
          "None", "n/a", "nan", "null"}


def _load_image(path: str, downscale: int, appearance_wh: Tuple[int, int]):
    """-> (rgbs (h*w, 3) [0,1], (w, h), appearance (Ha, Wa, 3) [-1,1])."""
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError(
            f"decoding {path} needs PIL, which is not installed: build the "
            "scene cache where it is (python -m crnerf_tpu_torch prepare "
            "--root_dir ...) and train from cache_tpu/scene_ds*.npz"
        ) from None
    img = Image.open(path).convert("RGB")
    w, h = img.size
    if downscale > 1:
        w, h = w // downscale, h // downscale
        img_rs = img.resize((w, h), Image.LANCZOS)
    else:
        img_rs = img
    rgbs = np.asarray(img_rs, np.float32).reshape(-1, 3) / 255.0
    app = img.resize(appearance_wh, Image.LANCZOS)
    app = np.asarray(app, np.float32) / 255.0 * 2.0 - 1.0
    return rgbs, (w, h), app


def cache_path(root_dir: str, downscale: int) -> str:
    return os.path.join(root_dir, "cache_tpu", f"scene_ds{downscale}.npz")


def _read_tsv(path: str):
    """-> [(filename, split)] of the rows whose id is not null."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    return [(r["filename"], r["split"]) for r in rows
            if (r.get("id") or "").strip() not in _NULLS]


def load_phototourism(
    root_dir: str,
    img_downscale: int = 2,
    appearance_wh: Tuple[int, int] = (224, 160),
    use_cache: bool = True,
    load_test_images: bool = True,
) -> Scene:
    cache = cache_path(root_dir, img_downscale)
    if use_cache and os.path.exists(cache):
        return load_scene_cache(cache)

    tsv_matches = glob.glob(os.path.join(root_dir, "*.tsv"))
    if not tsv_matches:
        raise FileNotFoundError(
            f"no <scene>.tsv split file under {root_dir!r} and no cache at "
            f"{cache}: is this a phototourism scene root (<scene>.tsv + "
            "dense/)?"
        )
    tsv = tsv_matches[0]
    scene_name = os.path.basename(tsv)[:-4]
    files = _read_tsv(tsv)

    sparse = os.path.join(root_dir, "dense/sparse")
    imdata = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    camdata = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    pts3d = colmap.read_points3d_binary(os.path.join(sparse, "points3D.bin"))

    name_to_id = {v.name: k for k, v in imdata.items()}
    rows = [(name_to_id[fn], fn, split) for fn, split in files
            if fn in name_to_id]   # (colmap_id, filename, split)

    # ---- intrinsics at downscale
    Ks: Dict[int, np.ndarray] = {}
    whs: Dict[int, Tuple[int, int]] = {}
    for id_, _, _ in rows:
        fx, fy, cx, cy = camdata[id_].params[:4]
        w0, h0 = int(cx * 2), int(cy * 2)
        w_, h_ = w0 // img_downscale, h0 // img_downscale
        Ks[id_] = np.array(
            [[fx * w_ / w0, 0, cx * w_ / w0],
             [0, fy * h_ / h0, cy * h_ / h0],
             [0, 0, 1]], np.float32)
        whs[id_] = (w_, h_)

    # ---- poses + near/far + global scale
    w2c = {}
    for id_, _, _ in rows:
        im = imdata[id_]
        m = np.eye(4)
        m[:3, :3] = colmap.qvec2rotmat(im.qvec)
        m[:3, 3:] = im.tvec.reshape(3, 1)
        w2c[id_] = m
    xyz_world = np.stack([p.xyz for p in pts3d.values()], 0)
    xyz_h = np.concatenate([xyz_world, np.ones((len(xyz_world), 1))], -1)

    c2w: Dict[int, np.ndarray] = {}
    nears: Dict[int, float] = {}
    fars: Dict[int, float] = {}
    for id_, _, _ in rows:
        cam_pts = (xyz_h @ w2c[id_].T)[:, :3]
        z = cam_pts[cam_pts[:, 2] > 0, 2]
        nears[id_] = float(np.percentile(z, 0.1))
        fars[id_] = float(np.percentile(z, 99.9))
        inv = np.linalg.inv(w2c[id_])[:3]
        inv[:, 1:3] *= -1  # right-down-front -> right-up-back
        c2w[id_] = inv.astype(np.float32)

    scale = max(fars.values()) / 5.0
    for id_, _, _ in rows:
        c2w[id_][:, 3] /= scale
        nears[id_] /= scale
        fars[id_] /= scale

    # ---- decode images
    images = []
    for id_, fn, split in rows:
        rgbs, wh, app = None, whs[id_], None
        if split == "train" or load_test_images:
            rgbs, wh, app = _load_image(
                os.path.join(root_dir, "dense/images", fn), img_downscale,
                appearance_wh)
        images.append(SceneImage(
            id=id_, name=fn, K=Ks[id_], c2w=c2w[id_], near=nears[id_],
            far=fars[id_], wh=wh, rgbs=rgbs, appearance=app, split=split))
    return Scene(name=scene_name, images=images, white_back=False,
                 appearance_wh=appearance_wh)


# --------------------------------------------------------------- caching
def save_scene_cache(scene: Scene, path: Optional[str] = None,
                     root_dir: Optional[str] = None,
                     img_downscale: int = 2) -> str:
    """A loaded Scene -> one compressed npz (at ``path``, or at
    ``cache_path(root_dir, img_downscale)``)."""
    if path is None:
        path = cache_path(root_dir, img_downscale)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ims = scene.images
    meta = dict(
        scene_name=scene.name,
        appearance_wh=np.asarray(scene.appearance_wh, np.int64),
        ids=np.asarray([im.id for im in ims], np.int64),
        names=np.asarray([im.name for im in ims]),
        Ks=np.stack([im.K for im in ims], 0),
        c2ws=np.stack([im.c2w for im in ims], 0),
        nears=np.asarray([im.near for im in ims], np.float32),
        fars=np.asarray([im.far for im in ims], np.float32),
        whs=np.asarray([im.wh for im in ims], np.int64),
        splits=np.asarray([im.split for im in ims]),
        has_pixels=np.asarray([im.rgbs is not None for im in ims], bool),
    )
    arrays = {}
    for i, im in enumerate(ims):
        if im.rgbs is not None:
            arrays[f"rgbs_{i}"] = im.rgbs.astype(np.float32)
            arrays[f"app_{i}"] = im.appearance.astype(np.float32)
    np.savez_compressed(path, **meta, **arrays)
    return path


def load_scene_cache(path: str) -> Scene:
    with np.load(path, allow_pickle=False) as z:
        images = []
        for i in range(len(z["ids"])):
            has_px = bool(z["has_pixels"][i])
            images.append(SceneImage(
                id=int(z["ids"][i]),
                name=str(z["names"][i]),
                K=z["Ks"][i],
                c2w=z["c2ws"][i],
                near=float(z["nears"][i]),
                far=float(z["fars"][i]),
                wh=(int(z["whs"][i][0]), int(z["whs"][i][1])),
                rgbs=z[f"rgbs_{i}"] if has_px else None,
                appearance=z[f"app_{i}"] if has_px else None,
                split=str(z["splits"][i]),
            ))
        return Scene(
            name=str(z["scene_name"]), images=images, white_back=False,
            appearance_wh=(int(z["appearance_wh"][0]),
                           int(z["appearance_wh"][1])))
