"""NeRF-Synthetic (Blender) dataset loader.

Port of ``nerfacc_tpu/datasets/nerf_synthetic.py:25-240``: the
``transforms_*.json`` and PNG loader (``trainval`` included), random-pixel
ray batches for training and full-image batches for eval, RGBA composited
over a background colour.  Batches are made in numpy on the host, with the
JAX package's numpy draws (the same seed gives the same batches), and each
batch goes to ``device`` in one transfer.

The JAX loader also has a native OpenMP sampler for training batches
(``nerf_synthetic.py:151-185``, ``datasets/_native.py``); it is not ported
yet, so this loader always takes the numpy path.  PNGs are read by the
port's own decoder (:mod:`~nerfacc_tpu_torch.datasets.png`).
"""

from __future__ import annotations

import json
import os
from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from .png import read_png
from .utils import Rays, camera_rays


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

    def fetch_data(self, index: int) -> dict:
        """One batch: random pixels across images (train) or the full image
        ``index`` (eval).  Returns a dict with ``rays`` (:class:`Rays`),
        ``pixels`` and ``color_bkgd``, on ``device``."""
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

        # One host-to-device transfer a batch.
        n = origins.shape[0]
        flat = np.concatenate(
            [origins.reshape(-1), viewdirs.reshape(-1), pixels.reshape(-1), color_bkgd]
        ).astype(np.float32)
        flat = torch.from_numpy(flat).to(self.device)
        shape = (n, 3) if self.training else (self.HEIGHT, self.WIDTH, 3)
        o, d, p = (flat[i * 3 * n : (i + 1) * 3 * n].view(shape) for i in range(3))
        return {"rays": Rays(origins=o, viewdirs=d), "pixels": p, "color_bkgd": flat[9 * n :]}
