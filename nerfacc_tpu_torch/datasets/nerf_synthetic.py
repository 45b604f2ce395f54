"""NeRF-Synthetic (Blender) dataset loader.

Port of ``nerfacc_tpu/datasets/nerf_synthetic.py:25-240``: the
``transforms_*.json`` and PNG loader (``trainval`` included), random-pixel
ray batches for training and full-image batches for eval, RGBA composited
over a background colour.  Batches are made in numpy on the host, with the
JAX package's numpy draws (the same seed gives the same batches), and each
batch goes to ``device`` in one transfer.

Training batches over images go through the native OpenMP sampler
(``csrc/rayforge.cpp``, :mod:`~nerfacc_tpu_torch.datasets._native`), as in
the JAX loader once its library is built (``nerf_synthetic.py:140-185``):
the same numpy draws pick the background and the sampler's seed, so both
give the same batches.  The port builds the sampler at first use; setting
``NATIVE_SAMPLER`` to False on the class takes the numpy path, the JAX
loader's path while its library is not built.  PNGs are read by the port's
own decoder (:mod:`~nerfacc_tpu_torch.datasets.png`).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from . import _native
from .png import read_png
from .utils import Rays, batch_on_device, camera_rays, generate_rays  # noqa: F401  (Rays, generate_rays: as the JAX module)


def _load_renderings(root_fp: str, subject_id: str, split: str):
    """PNGs and poses of one split (``nerf_synthetic.py:25-41``)."""
    data_dir = os.path.join(root_fp, subject_id)
    with open(os.path.join(data_dir, f"transforms_{split}.json")) as fp:
        meta = json.load(fp)
    images, camtoworlds = [], []
    for frame in meta["frames"]:
        images.append(read_png(os.path.join(data_dir, frame["file_path"] + ".png")))
        camtoworlds.append(frame["transform_matrix"])
    images = np.stack(images, axis=0)
    camtoworlds = np.stack(camtoworlds, axis=0).astype(np.float32)
    w = images.shape[2]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return images, camtoworlds, focal


class SubjectLoader:
    """Single-subject loader (``nerf_synthetic.py:44-240``).

    Also takes arrays through ``images=``/``camtoworlds=``/``focal=`` (the
    procedural scene's path), bypassing the disk.  Images and poses stay on
    the host; :meth:`fetch_data` returns the batch on ``device``.
    """

    SPLITS = ["train", "val", "trainval", "test"]
    WIDTH, HEIGHT = 800, 800
    NEAR, FAR = 2.0, 6.0
    OPENGL_CAMERA = True
    NATIVE_SAMPLER = True  # training batches over images through csrc/rayforge.cpp

    def __init__(
        self,
        subject_id: str = "",
        root_fp: str = "",
        split: str = "train",
        color_bkgd_aug: str = "white",
        num_rays: Optional[int] = None,
        near: Optional[float] = None,
        far: Optional[float] = None,
        batch_over_images: bool = True,
        images: Optional[np.ndarray] = None,
        camtoworlds: Optional[np.ndarray] = None,
        focal: Optional[float] = None,
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
        self.near = self.NEAR if near is None else near
        self.far = self.FAR if far is None else far
        self.training = (num_rays is not None) and split in ["train", "trainval"]
        self.color_bkgd_aug = color_bkgd_aug
        self.batch_over_images = batch_over_images
        self._rng = np.random.default_rng(seed)

        if images is not None:
            self.images = images
            self.camtoworlds = camtoworlds.astype(np.float32)
            self.focal = float(focal)
        elif split == "trainval":
            im_t, c_t, f_t = _load_renderings(root_fp, subject_id, "train")
            im_v, c_v, _ = _load_renderings(root_fp, subject_id, "val")
            self.images = np.concatenate([im_t, im_v])
            self.camtoworlds = np.concatenate([c_t, c_v])
            self.focal = f_t
        else:
            self.images, self.camtoworlds, self.focal = _load_renderings(root_fp, subject_id, split)
        # Contiguous host memory once: fancy indexing of a non-contiguous
        # array would copy it on every fetch.
        self.images = np.ascontiguousarray(np.asarray(self.images))
        self.HEIGHT, self.WIDTH = self.images.shape[1:3]
        self.K = np.array(
            [
                [self.focal, 0, self.WIDTH / 2.0],
                [0, self.focal, self.HEIGHT / 2.0],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )

    def __len__(self):
        return len(self.images)

    def update_num_rays(self, num_rays: int):
        """Change the training batch's ray count (``nerf_synthetic.py:161``)."""
        self.num_rays = num_rays

    def __getitem__(self, index: int):
        return self.fetch_data(index)

    def _background(self) -> np.ndarray:
        if self.training and self.color_bkgd_aug == "random":
            return self._rng.random(3).astype(np.float32)
        if self.training and self.color_bkgd_aug == "black":
            return np.zeros(3, np.float32)
        return np.ones(3, np.float32)

    def _native_image_ids(self, seed: int, n_rays: int) -> np.ndarray:
        """Each ray's view in the native sampler's batch for ``seed``."""
        return _native.image_ids(seed, n_rays, len(self.images))

    def _to_device(self, origins, viewdirs, pixels, color_bkgd) -> dict:
        shape = (origins.shape[0], 3) if self.training else (self.HEIGHT, self.WIDTH, 3)
        return batch_on_device(origins, viewdirs, pixels, color_bkgd, shape, self.device)

    def fetch_data(self, index: int) -> dict:
        """One batch: random pixels across images (train) or the full image
        ``index`` (eval).  Returns a dict with ``rays`` (:class:`Rays`),
        ``pixels`` and ``color_bkgd``, on ``device``."""
        rng = self._rng
        num_rays = self.num_rays
        if self.training and self.batch_over_images and self.NATIVE_SAMPLER:
            # The JAX loader's native branch, its draws in its order.
            color_bkgd = self._background()
            seed = int(rng.integers(0, 2**63 - 1))
            o, d, pixels = _native.sample_rays(
                self.images, self.camtoworlds, self.K, color_bkgd, seed, num_rays, self.OPENGL_CAMERA
            )
            self._last_image_id = self._native_image_ids(seed, num_rays)
            return self._to_device(o, d, pixels, color_bkgd)
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

        self._last_image_id = image_id  # each ray's view, for the dynamic loader's timestamps
        rgba = self.images[image_id, y, x].astype(np.float32) / 255.0
        c2w = self.camtoworlds[image_id, :3, :4]
        origins, viewdirs = camera_rays(
            x.astype(np.float32), y.astype(np.float32), self.K, c2w, opengl=self.OPENGL_CAMERA
        )
        color_bkgd = self._background()
        if rgba.shape[-1] == 4:
            pixels, alpha = rgba[..., :3], rgba[..., 3:]
            pixels = pixels * alpha + color_bkgd * (1.0 - alpha)
        else:
            pixels = rgba

        return self._to_device(origins, viewdirs, pixels, color_bkgd)
