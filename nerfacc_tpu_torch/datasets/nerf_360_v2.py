"""Mip-NeRF 360 (COLMAP) dataset loader.

Port of ``nerfacc_tpu/datasets/nerf_360_v2.py``: the COLMAP sparse model
(:mod:`~nerfacc_tpu_torch.datasets.colmap`), pinhole cameras only, the
``images``/``images_{factor}`` folders, every 8th view held out for test,
and ``similarity_from_cameras``' up-axis, recentring and scale
normalisation; OpenCV cameras.  Images are read by the port's own PNG and
JPEG readers (:func:`~nerfacc_tpu_torch.datasets.jpeg.read_image`).
Batches are made in numpy on the host with the JAX loader's draws, in its
order (the same seed gives the same batches), and each goes to ``device``
in one transfer.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .colmap import load_sparse
from .jpeg import read_image
from .utils import Rays, batch_on_device, camera_rays, generate_rays  # noqa: F401  (Rays, generate_rays: as the JAX module)


def similarity_from_cameras(c2w: np.ndarray, strict_scaling: bool = False):
    """The normalising similarity transform (``nerf_360_v2.py:21-68``, the
    recipe of nerf-factory that upstream nerfacc credits): a rotation that
    takes the cameras' mean up direction (their -y axis) onto -y, a shift to
    the median of the points on each camera's axis nearest the origin, and
    the inverse of the median (``max`` with ``strict_scaling``) camera
    distance after both.  Returns ``(transform, scale)``."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    ups = np.sum(R * np.array([0, -1.0, 0]), axis=-1)
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)

    up_camspace = np.array([0.0, -1.0, 0.0])
    c = (up_camspace * world_up).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array(
        [
            [0.0, -cross[2], cross[1]],
            [cross[2], 0.0, -cross[0]],
            [-cross[1], cross[0], 0.0],
        ]
    )
    if c > -1:
        R_align = np.eye(3) + skew + (skew @ skew) / (1 + c)
    else:
        R_align = np.array([[-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])

    R = R_align @ R
    fwds = np.sum(R * np.array([0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]

    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)

    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align

    scale_fn = np.max if strict_scaling else np.median
    scale = 1.0 / scale_fn(np.linalg.norm(t + translate, axis=-1))
    return transform, scale


def _load_colmap(root_fp: str, subject_id: str, factor: int = 1):
    """The capture's images, poses, intrinsics and split
    (``nerf_360_v2.py:71-115``): the first camera's ``K`` divided by
    ``factor``, the images of ``images_{factor}`` mapped by sorted name onto
    COLMAP's ``images``, every 8th view (in name order) for test."""
    if factor not in (1, 2, 4, 8):
        raise ValueError(f"factor {factor} not in (1, 2, 4, 8)")
    data_dir = os.path.join(root_fp, subject_id)
    cams, imdata = load_sparse(os.path.join(data_dir, "sparse/0/"))
    cam = cams[min(cams.keys())]
    if cam.model not in ("SIMPLE_PINHOLE", "PINHOLE"):
        raise ValueError(f"only pinhole cameras are supported, not {cam.model}")
    K = cam.K.copy()
    K[:2, :] /= factor

    w2c_mats = np.stack([imdata[k].w2c() for k in imdata])
    camtoworlds = np.linalg.inv(w2c_mats)
    image_names = [imdata[k].name for k in imdata]
    inds = np.argsort(image_names)
    image_names = [image_names[i] for i in inds]
    camtoworlds = camtoworlds[inds]

    image_dir_suffix = f"_{factor}" if factor > 1 else ""
    colmap_image_dir = os.path.join(data_dir, "images")
    image_dir = os.path.join(data_dir, "images" + image_dir_suffix)
    for d in (image_dir, colmap_image_dir):
        if not os.path.exists(d):
            raise ValueError(f"Image folder {d} does not exist.")
    colmap_files = sorted(os.listdir(colmap_image_dir))
    image_files = sorted(os.listdir(image_dir))
    colmap_to_image = dict(zip(colmap_files, image_files))
    image_paths = [os.path.join(image_dir, colmap_to_image[f]) for f in image_names]
    images = np.stack([read_image(x) for x in image_paths], axis=0)

    all_indices = np.arange(images.shape[0])
    split_indices = {
        "test": all_indices[all_indices % 8 == 0],
        "train": all_indices[all_indices % 8 != 0],
    }
    return images, camtoworlds, K, split_indices


class SubjectLoader:
    """Mip-NeRF 360 subject loader (``nerf_360_v2.py:118-222``).  Images and
    poses stay on the host; :meth:`fetch_data` returns the batch on
    ``device``."""

    SPLITS = ["train", "test"]
    OPENGL_CAMERA = False

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str,
        color_bkgd_aug: str = "white",
        num_rays: Optional[int] = None,
        near: Optional[float] = None,
        far: Optional[float] = None,
        batch_over_images: bool = True,
        factor: int = 1,
        seed: int = 0,
        *,
        device: Union[str, torch.device] = "cuda",
    ):
        if split not in self.SPLITS:
            raise ValueError(f"split {split!r} not in {self.SPLITS}")
        if color_bkgd_aug not in ("white", "black", "random"):
            raise ValueError(f"color_bkgd_aug {color_bkgd_aug!r} not in ('white', 'black', 'random')")
        self.device = resolve_device(device)
        self.split = split
        self.num_rays = num_rays
        self.near = near
        self.far = far
        self.training = (num_rays is not None) and split in ["train", "trainval"]
        self.color_bkgd_aug = color_bkgd_aug
        self.batch_over_images = batch_over_images
        self._rng = np.random.default_rng(seed)

        self.images, self.camtoworlds, self.K, split_indices = _load_colmap(root_fp, subject_id, factor)
        T, sscale = similarity_from_cameras(self.camtoworlds, strict_scaling=False)
        self.camtoworlds = np.einsum("nij, ki -> nkj", self.camtoworlds, T)
        self.camtoworlds[:, :3, 3] *= sscale
        indices = split_indices[split]
        self.images = np.ascontiguousarray(self.images[indices])
        self.camtoworlds = self.camtoworlds[indices].astype(np.float32)
        self.K = self.K.astype(np.float32)
        self.HEIGHT, self.WIDTH = self.images.shape[1:3]

    def __len__(self):
        return len(self.images)

    def update_num_rays(self, num_rays: int):
        self.num_rays = num_rays

    def __getitem__(self, index: int):
        return self.fetch_data(index)

    def fetch_data(self, index: int) -> dict:
        """One batch: random pixels across images (train) or the full image
        ``index`` (eval), the RGB channels only.  Returns a dict with
        ``rays``, ``pixels`` and ``color_bkgd``, on ``device``."""
        rng = self._rng
        num_rays = self.num_rays
        if self.training:
            if self.batch_over_images:
                image_id = rng.integers(0, len(self.images), size=(num_rays,))
            else:
                image_id = np.full((num_rays,), index)
            x = rng.integers(0, self.WIDTH, size=(num_rays,))
            y = rng.integers(0, self.HEIGHT, size=(num_rays,))
        else:
            image_id = np.full((self.HEIGHT * self.WIDTH,), index)
            xx, yy = np.meshgrid(np.arange(self.WIDTH), np.arange(self.HEIGHT))
            x, y = xx.reshape(-1), yy.reshape(-1)

        rgb = self.images[image_id, y, x].astype(np.float32) / 255.0
        rgb = rgb[..., :3]
        c2w = self.camtoworlds[image_id, :3, :4]
        origins, viewdirs = camera_rays(
            x.astype(np.float32), y.astype(np.float32), self.K, c2w, opengl=self.OPENGL_CAMERA
        )
        if self.training and self.color_bkgd_aug == "random":
            color_bkgd = rng.random(3).astype(np.float32)
        elif self.training and self.color_bkgd_aug == "black":
            color_bkgd = np.zeros(3, np.float32)
        else:
            color_bkgd = np.ones(3, np.float32)
        shape = (num_rays, 3) if self.training else (self.HEIGHT, self.WIDTH, 3)
        return batch_on_device(origins, viewdirs, rgb, color_bkgd, shape, self.device)
