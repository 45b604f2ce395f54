"""Helpers shared by the port's CLIs: metrics, chunked eval renders, a
timer, the scene lists and the loaders of a scene on disk.

Port of ``examples/common.py``.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import torch

from ..datasets.utils import Rays

Tensor = torch.Tensor

NERF_SYNTHETIC_SCENES = [
    "chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship",
]
MIPNERF360_UNBOUNDED_SCENES = [
    "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
]


def scene_loaders(scene: str, data_root: str, train_split: str, num_rays: int, device):
    """The train and test loaders of ``scene`` under ``data_root``: a
    Mip-NeRF 360 scene through ``nerf_360_v2.SubjectLoader`` with upstream
    nerfacc's arguments (``factor=4`` for both splits, a random background
    for training), any other through the NeRF-Synthetic loader.  The JAX
    examples open every scene with the NeRF-Synthetic loader
    (``examples/train_ngp_nerf_occ.py:33,136-145``), which fails on a
    COLMAP folder (``ROADMAP.md``, Queue 3)."""
    if scene in MIPNERF360_UNBOUNDED_SCENES:
        from ..datasets.nerf_360_v2 import SubjectLoader

        train = SubjectLoader(subject_id=scene, root_fp=data_root, split=train_split, num_rays=num_rays,
                              color_bkgd_aug="random", factor=4, device=device)
        return train, SubjectLoader(subject_id=scene, root_fp=data_root, split="test", factor=4, device=device)
    from ..datasets.nerf_synthetic import SubjectLoader

    train = SubjectLoader(subject_id=scene, root_fp=data_root, split=train_split, num_rays=num_rays, device=device)
    return train, SubjectLoader(subject_id=scene, root_fp=data_root, split="test", device=device)


def psnr(pred: Tensor, target: Tensor) -> float:
    mse = float(torch.mean((pred - target) ** 2))
    return -10.0 * math.log10(max(mse, 1e-10))


def eval_metrics(pred: Tensor, target: Tensor) -> dict:
    """PSNR, SSIM, MS-SSIM and LPIPS (LPIPS-vgg with a weights file, else the
    fixed-seed backbone, labelled by ``lpips_src``; see
    :mod:`~nerfacc_tpu_torch.utils.lpips`)."""
    from ..utils.lpips import lpips
    from ..utils.metrics import ms_ssim, ssim

    lp, lp_src = lpips(pred, target)
    return {
        "psnr": psnr(pred, target),
        "ssim": float(ssim(pred, target)),
        "ms_ssim": float(ms_ssim(pred, target)),
        "lpips": lp,
        "lpips_src": lp_src,
    }


@torch.no_grad()
def render_image_chunked(render_fn: Callable, rays: Rays, chunk: int = 8192) -> Tensor:
    """Render an ``(H, W)`` image of rays through ``render_fn(origins,
    directions) -> colors`` in chunks of ``chunk`` rays, the last chunk
    padded with the last ray (every chunk has one shape, as in the JAX
    package)."""
    h, w = rays.origins.shape[:2]
    o = rays.origins.reshape(-1, 3)
    d = rays.viewdirs.reshape(-1, 3)
    n = o.shape[0]
    n_pad = (-n) % chunk
    o = torch.cat([o, o[-1:].expand(n_pad, 3)])
    d = torch.cat([d, d[-1:].expand(n_pad, 3)])
    outs = [render_fn(o[i : i + chunk], d[i : i + chunk]) for i in range(0, n + n_pad, chunk)]
    return torch.cat(outs)[:n].reshape(h, w, 3)


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0
