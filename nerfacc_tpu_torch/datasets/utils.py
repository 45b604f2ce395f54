"""Ray containers and camera ray generation.

Port of ``nerfacc_tpu/datasets/utils.py``.  Rays are computed in numpy, as
the JAX package computes them, and then placed on ``device``, so both
packages render from bit-identical rays.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch

from ..device import resolve_device

Tensor = torch.Tensor


class Rays(NamedTuple):
    origins: Tensor  # (..., 3)
    viewdirs: Tensor  # (..., 3)


def generate_rays(
    x: np.ndarray,  # pixel cols (...,)
    y: np.ndarray,  # pixel rows (...,)
    K: np.ndarray,  # (3, 3) intrinsics
    c2w: np.ndarray,  # (..., 3, 4) or (3, 4) camera-to-world
    opengl: bool = True,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Rays:
    """Pixel-center rays; OpenGL (-z forward) or OpenCV (+z) convention."""
    device = resolve_device(device)
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    sign = -1.0 if opengl else 1.0
    dirs = np.stack(
        [
            (x + 0.5 - cx) / fx,
            (y + 0.5 - cy) / fy * sign,
            sign * np.ones_like(x),
        ],
        axis=-1,
    )  # (..., 3) camera space
    rot = c2w[..., :3, :3]
    trans = c2w[..., :3, 3]
    d = (dirs[..., None, :] * rot).sum(-1)
    viewdirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
    origins = np.broadcast_to(trans, viewdirs.shape)
    return Rays(
        origins=torch.from_numpy(origins.astype(np.float32)).to(device),
        viewdirs=torch.from_numpy(viewdirs.astype(np.float32)).to(device),
    )
