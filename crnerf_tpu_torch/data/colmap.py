"""COLMAP sparse-reconstruction readers and writers, binary and text
(``crnerf_tpu/data/colmap.py``; numpy and struct only).

Implements the COLMAP output format from its public spec
(https://colmap.github.io/format.html): cameras, images and points3D in
their ``.bin`` and ``.txt`` forms, the binary writers (for fixtures), and
the quaternion <-> rotation-matrix conversions. Runs once, when a scene's
cache is built.
"""

from __future__ import annotations

import collections
import os
import struct
from typing import Dict

import numpy as np

CameraModel = collections.namedtuple(
    "CameraModel", ["model_id", "model_name", "num_params"]
)
Camera = collections.namedtuple(
    "Camera", ["id", "model", "width", "height", "params"]
)
BaseImage = collections.namedtuple(
    "Image", ["id", "qvec", "tvec", "camera_id", "name", "xys", "point3D_ids"]
)
Point3D = collections.namedtuple(
    "Point3D", ["id", "xyz", "rgb", "error", "image_ids", "point2D_idxs"]
)


class Image(BaseImage):
    def qvec2rotmat(self):
        return qvec2rotmat(self.qvec)


CAMERA_MODELS = [
    CameraModel(0, "SIMPLE_PINHOLE", 3),
    CameraModel(1, "PINHOLE", 4),
    CameraModel(2, "SIMPLE_RADIAL", 4),
    CameraModel(3, "RADIAL", 5),
    CameraModel(4, "OPENCV", 8),
    CameraModel(5, "OPENCV_FISHEYE", 8),
    CameraModel(6, "FULL_OPENCV", 12),
    CameraModel(7, "FOV", 5),
    CameraModel(8, "SIMPLE_RADIAL_FISHEYE", 4),
    CameraModel(9, "RADIAL_FISHEYE", 5),
    CameraModel(10, "THIN_PRISM_FISHEYE", 12),
]
CAMERA_MODEL_IDS = {m.model_id: m for m in CAMERA_MODELS}
CAMERA_MODEL_NAMES = {m.model_name: m for m in CAMERA_MODELS}


def qvec2rotmat(qvec):
    """Hamilton quaternion (w, x, y, z) -> 3x3 rotation matrix."""
    w, x, y, z = qvec
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w,
         2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z,
         2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w,
         1 - 2 * x * x - 2 * y * y],
    ])


def rotmat2qvec(R):
    """Inverse of qvec2rotmat (largest-eigenvector method)."""
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = np.array([
        [Rxx - Ryy - Rzz, 0, 0, 0],
        [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
        [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
        [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
    ]) / 3.0
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


def _read(fid, n_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(n_bytes))


def read_cameras_binary(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, 24, "iiQQ")
            model = CAMERA_MODEL_IDS[model_id]
            params = _read(f, 8 * model.num_params, "d" * model.num_params)
            cameras[cam_id] = Camera(
                cam_id, model.model_name, width, height,
                np.array(params),
            )
    return cameras


def read_images_binary(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            vals = _read(f, 64, "idddddddi")
            image_id = vals[0]
            qvec = np.array(vals[1:5])
            tvec = np.array(vals[5:8])
            camera_id = vals[8]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            (n_pts,) = _read(f, 8, "Q")
            data = _read(f, 24 * n_pts, "ddq" * n_pts)
            xys = np.column_stack(
                [np.array(data[0::3]), np.array(data[1::3])]
            )
            p3d = np.array(data[2::3], dtype=np.int64)
            images[image_id] = Image(
                image_id, qvec, tvec, camera_id, name.decode("utf-8"),
                xys, p3d,
            )
    return images


def read_points3d_binary(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            vals = _read(f, 43, "QdddBBBd")
            pid = vals[0]
            xyz = np.array(vals[1:4])
            rgb = np.array(vals[4:7])
            err = vals[7]
            (track_len,) = _read(f, 8, "Q")
            track = _read(f, 8 * track_len, "ii" * track_len)
            points[pid] = Point3D(
                pid, xyz, rgb, err,
                np.array(track[0::2], np.int64),
                np.array(track[1::2], np.int64),
            )
    return points


def read_cameras_text(path: str) -> Dict[int, Camera]:
    cameras = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cameras[int(e[0])] = Camera(
                int(e[0]), e[1], int(e[2]), int(e[3]),
                np.array(tuple(map(float, e[4:]))),
            )
    return cameras


def read_images_text(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [
            ln.strip() for ln in f
            if ln.strip() and not ln.strip().startswith("#")
        ]
    for i in range(0, len(lines), 2):
        e = lines[i].split()
        pts = lines[i + 1].split()
        xys = np.column_stack([
            np.array(pts[0::3], np.float64),
            np.array(pts[1::3], np.float64),
        ]) if pts else np.zeros((0, 2))
        p3d = np.array(pts[2::3], np.int64) if pts else np.zeros(0, np.int64)
        images[int(e[0])] = Image(
            int(e[0]), np.array(e[1:5], np.float64),
            np.array(e[5:8], np.float64), int(e[8]), e[9], xys, p3d,
        )
    return images


def read_points3d_text(path: str) -> Dict[int, Point3D]:
    points = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            points[int(e[0])] = Point3D(
                int(e[0]), np.array(e[1:4], np.float64),
                np.array(e[4:7], np.int64), float(e[7]),
                np.array(e[8::2], np.int64), np.array(e[9::2], np.int64),
            )
    return points


def write_cameras_binary(cameras: Dict[int, Camera], path: str):
    """Writer (for fixtures)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for cam in cameras.values():
            model = CAMERA_MODEL_NAMES[cam.model]
            f.write(struct.pack(
                "<iiQQ", cam.id, model.model_id, cam.width, cam.height
            ))
            f.write(struct.pack(
                "<" + "d" * model.num_params, *cam.params
            ))


def write_images_binary(images: Dict[int, Image], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack(
                "<idddddddi", im.id, *im.qvec, *im.tvec, im.camera_id
            ))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", len(im.point3D_ids)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], pid))


def write_points3d_binary(points: Dict[int, Point3D], path: str):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points.values():
            f.write(struct.pack(
                "<QdddBBBd", p.id, *p.xyz, *p.rgb.astype(np.uint8), p.error
            ))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pidx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", iid, pidx))
