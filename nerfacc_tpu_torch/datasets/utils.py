"""Ray containers and camera ray generation.

Port of ``nerfacc_tpu/datasets/utils.py``.  Rays are computed in numpy, as
the JAX package computes them, and then placed on ``device``, so both
packages render from bit-identical rays.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device

Tensor = torch.Tensor


class Rays(NamedTuple):
    origins: Tensor  # (..., 3)
    viewdirs: Tensor  # (..., 3)


def namedtuple_map(fn, tup):
    """``fn`` on every field of ``tup`` that is not None."""
    return type(tup)(*(None if x is None else fn(x) for x in tup))


def camera_rays(
    x: np.ndarray,  # pixel cols (...,)
    y: np.ndarray,  # pixel rows (...,)
    K: np.ndarray,  # (3, 3) intrinsics
    c2w: np.ndarray,  # (..., 3, 4) or (3, 4) camera-to-world
    opengl: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pixel-center rays as float32 numpy ``(origins, viewdirs)``; OpenGL
    (-z forward) or OpenCV (+z) convention."""
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
    return origins.astype(np.float32), viewdirs.astype(np.float32)


def generate_rays(
    x: np.ndarray,
    y: np.ndarray,
    K: np.ndarray,
    c2w: np.ndarray,
    opengl: bool = True,
    *,
    device: Union[str, torch.device] = "cuda",
) -> Rays:
    """:func:`camera_rays` placed on ``device``."""
    device = resolve_device(device)
    origins, viewdirs = camera_rays(x, y, K, c2w, opengl)
    return Rays(
        origins=torch.from_numpy(origins).to(device),
        viewdirs=torch.from_numpy(viewdirs).to(device),
    )


def batch_on_device(origins: np.ndarray, viewdirs: np.ndarray, pixels: np.ndarray, color_bkgd: np.ndarray,
                    shape: Tuple[int, ...], device: torch.device) -> dict:
    """A loader's batch dict (``rays``, ``pixels``, ``color_bkgd``) on
    ``device`` in one host-to-device transfer; the rays and pixels take
    ``shape`` (``(n, 3)`` or ``(H, W, 3)``)."""
    n = origins.size // 3
    flat = np.concatenate(
        [origins.reshape(-1), viewdirs.reshape(-1), pixels.reshape(-1), color_bkgd]
    ).astype(np.float32)
    flat = torch.from_numpy(flat).to(device)
    o, d, p = (flat[i * 3 * n : (i + 1) * 3 * n].view(shape) for i in range(3))
    return {"rays": Rays(origins=o, viewdirs=d), "pixels": p, "color_bkgd": flat[9 * n :]}
