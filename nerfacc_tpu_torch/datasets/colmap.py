"""A pure-Python reader of COLMAP sparse reconstructions.

Port of ``nerfacc_tpu/datasets/colmap.py:1-179``, a copy of its own (the
port imports nothing of the JAX package): ``cameras.bin``/``images.bin``
and the ``.txt`` variants, each camera's intrinsics ``K`` and distortion
parameters for the 11 COLMAP models, each image's rotation from its
quaternion and its world-to-camera matrix.  It stands in for upstream
nerfacc's ``pycolmap`` submodule (``examples/datasets/nerf_360_v2.py:19-25``).
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict

import numpy as np

# COLMAP camera model ids -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclass
class Camera:
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "SIMPLE_PINHOLE" or self.model in (
            "SIMPLE_RADIAL",
            "SIMPLE_RADIAL_FISHEYE",
        ):
            f, cx, cy = p[0], p[1], p[2]
            fx = fy = f
        elif self.model == "RADIAL" or self.model == "RADIAL_FISHEYE":
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:  # PINHOLE, OPENCV, OPENCV_FISHEYE, FULL_OPENCV, ...
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array(
            [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=np.float64
        )

    @property
    def distortion(self) -> np.ndarray:
        """Distortion params in the layout our undistortion kernels expect."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "PINHOLE"):
            return np.zeros(0)
        if self.model == "SIMPLE_RADIAL":
            return np.array([p[3]])
        if self.model == "RADIAL":
            return np.array([p[3], p[4]])
        if self.model == "OPENCV":
            return np.array([p[4], p[5], p[6], p[7]])  # k1 k2 p1 p2
        if self.model == "OPENCV_FISHEYE":
            return np.array([p[4], p[5], p[6], p[7]])  # k1 k2 k3 k4
        return p[4:]


@dataclass
class Image:
    name: str
    camera_id: int
    qvec: np.ndarray  # (4,) w x y z
    tvec: np.ndarray  # (3,)

    def R(self) -> np.ndarray:
        w, x, y, z = self.qvec
        return np.array(
            [
                [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
                [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
                [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
            ]
        )

    def w2c(self) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = self.R()
        m[:3, 3] = self.tvec
        return m


def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = Camera(name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> Dict[int, Image]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<I")
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            (cam_id,) = _read(f, "<I")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.read(n_pts * 24)  # skip 2D points (x, y, point3D_id)
            images[img_id] = Image(
                name.decode(), int(cam_id), qvec, tvec
            )
    return images


def read_cameras_txt(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            cams[int(parts[0])] = Camera(
                parts[1],
                int(parts[2]),
                int(parts[3]),
                np.array([float(x) for x in parts[4:]]),
            )
    return cams


def read_images_txt(path: str) -> Dict[int, Image]:
    images = {}
    with open(path) as f:
        lines = [
            l for l in f if not l.startswith("#") and l.strip()
        ]
    for meta in lines[0::2]:
        parts = meta.split()
        images[int(parts[0])] = Image(
            parts[9],
            int(parts[8]),
            np.array([float(x) for x in parts[1:5]]),
            np.array([float(x) for x in parts[5:8]]),
        )
    return images


def load_sparse(colmap_dir: str):
    """Load (cameras, images) from a COLMAP sparse dir (bin or txt)."""
    if os.path.exists(os.path.join(colmap_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(colmap_dir, "cameras.bin"))
        images = read_images_bin(os.path.join(colmap_dir, "images.bin"))
    else:
        cams = read_cameras_txt(os.path.join(colmap_dir, "cameras.txt"))
        images = read_images_txt(os.path.join(colmap_dir, "images.txt"))
    return cams, images
