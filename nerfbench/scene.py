"""The benchmark's stand-in for NeRF-Synthetic Lego: an analytic scene of
five textured, rippled emissive blobs, rendered on the card into RGBA views
taken with Lego's image size and field of view from the upper hemisphere.

The scene and its renderer are a frozen copy of the textured scene
(``detail=1``) of ``nerfacc_tpu_torch/datasets/procedural.py``; the
benchmark makes its own views so that its inputs do not change with the
program.  A view's pixel is the scene marched at 512 midpoint samples over
``[radius - 1.2, radius + 1.2]``; rays that pass farther than 1.0 from the
centre meet no blob (every blob lies within 0.93) and are transparent.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

# cx, cy, cz, radius, density, r, g, b
BLOBS = np.array(
    [
        [0.0, 0.0, 0.0, 0.45, 40.0, 0.85, 0.25, 0.2],
        [0.5, 0.3, -0.2, 0.3, 30.0, 0.2, 0.7, 0.9],
        [-0.5, -0.2, 0.35, 0.25, 50.0, 0.95, 0.8, 0.2],
        [0.1, -0.5, -0.4, 0.2, 60.0, 0.3, 0.9, 0.35],
        [-0.25, 0.55, 0.1, 0.22, 45.0, 0.7, 0.4, 0.9],
    ],
    dtype=np.float32,
)
N_STEPS = 512
REACH = 1.2  # the march's half-length about the camera radius
EMPTY_BEYOND = 1.0  # rays passing farther than this from the centre meet nothing


def scene_rgb_density(x: Tensor, blobs: Tensor) -> Tuple[Tensor, Tensor]:
    """``(rgb (..., 3), density (...))`` of the textured scene at ``x``."""
    dist2 = sum((x[..., i : i + 1] - blobs[:, i]) ** 2 for i in range(3))
    u = (1.0 - dist2 / (blobs[:, 3] ** 2)).clamp(min=0.0)
    w = blobs[:, 4] * u * u
    sigma = w.sum(-1)
    colors = sum(w[..., j : j + 1] * blobs[j, 5:8] for j in range(blobs.shape[0])) / sigma[..., None].clamp(min=1e-8)
    xx, yy, zz = x[..., :1], x[..., 1:2], x[..., 2:3]
    shade = 0.75 + 0.25 * torch.sin(4.0 * xx) * torch.cos(4.0 * yy)
    shade = shade + (
        0.22 * torch.sin(20.0 * xx + 1.0) * torch.sin(20.0 * zz)
        + 0.14 * torch.sin(55.0 * yy + 2.0) * torch.cos(55.0 * zz + 1.0)
        + 0.09 * torch.sin(200.0 * xx + 0.7) * torch.sin(200.0 * yy + 1.3)
    )
    sigma = sigma * (1.0 + 0.35 * torch.sin(40.0 * xx[..., 0] + 2.0 * yy[..., 0]) * torch.sin(40.0 * zz[..., 0]))
    return (colors * shade).clamp(0.0, 1.0), sigma


def focal_from_angle(width: int, camera_angle_x: float) -> float:
    return 0.5 * width / math.tan(0.5 * camera_angle_x)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world 4x4 (OpenGL axes) at ``radius`` looking at the origin."""
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1], rot_phi[1, 2], rot_phi[2, 1], rot_phi[2, 2] = np.cos(phi), -np.sin(phi), np.sin(phi), np.cos(phi)
    rot_theta = np.eye(4, dtype=np.float32)
    rot_theta[0, 0], rot_theta[0, 2], rot_theta[2, 0], rot_theta[2, 2] = (
        np.cos(theta), -np.sin(theta), np.sin(theta), np.cos(theta))
    return (rot_theta @ rot_phi @ trans).astype(np.float32)


def poses(n: int, phase: float, radius: float, rng: np.random.Generator) -> np.ndarray:
    """``n`` poses on a ring of azimuths, elevations drawn in [36, 59] degrees."""
    return np.stack([
        pose_spherical(2 * np.pi * i / n + phase, -np.pi / 5 - 0.4 * rng.random(), radius) for i in range(n)
    ])


def pixel_rays(x: Tensor, y: Tensor, focal: float, width: int, height: int, c2w: Tensor):
    """Unit rays through pixel centres (OpenGL camera: -z forward, +y up):
    ``(origins, directions)``, each ``x.shape + (3,)``; ``c2w`` is
    ``x.shape + (3, 4)`` or ``(3, 4)``."""
    cam = torch.stack([(x + 0.5 - width / 2.0) / focal, -(y + 0.5 - height / 2.0) / focal, -torch.ones_like(x)], -1)
    d = (cam[..., None, :] * c2w[..., :3, :3]).sum(-1)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    return torch.broadcast_to(c2w[..., :3, 3], d.shape), d


@torch.no_grad()
def render_views(c2ws: np.ndarray, width: int, height: int, focal: float, radius: float, device,
                 chunk: int = 1 << 15) -> np.ndarray:
    """uint8 RGBA views ``(n, height, width, 4)`` of the poses ``c2ws``."""
    blobs = torch.from_numpy(BLOBS).to(device)
    t = torch.linspace(radius - REACH, radius + REACH, N_STEPS + 1, device=device)
    t0, t1 = t[:-1], t[1:]
    tm = (t0 + t1) / 2.0
    ys, xs = torch.meshgrid(torch.arange(height, device=device, dtype=torch.float32),
                            torch.arange(width, device=device, dtype=torch.float32), indexing="ij")
    views = []
    for c2w in c2ws:
        o, d = pixel_rays(xs.reshape(-1), ys.reshape(-1), focal, width, height, torch.from_numpy(c2w[:3]).to(device))
        o = o.contiguous()
        rgba = torch.zeros((o.shape[0], 4), device=device)
        closest = torch.linalg.vector_norm(torch.linalg.cross(o, d), dim=-1)
        hit = torch.nonzero(closest < EMPTY_BEYOND)[:, 0]
        for lo in range(0, hit.shape[0], chunk):
            idx = hit[lo : lo + chunk]
            x = o[idx, None, :] + tm[None, :, None] * d[idx, None, :]
            rgb, sigma = scene_rgb_density(x, blobs)
            sdt = sigma * (t1 - t0)
            w = torch.exp(-(torch.cumsum(sdt, -1) - sdt)) * (1.0 - torch.exp(-sdt))
            rgba[idx] = torch.cat([(w[..., None] * rgb).sum(-2), w.sum(-1, keepdim=True)], -1)
        views.append((rgba.clamp(0, 1) * 255).to(torch.uint8).reshape(height, width, 4))
    return torch.stack(views).cpu().numpy()


def make_views(scene: dict, seed: int, device):
    """``(train_images, train_c2w, test_images, test_c2w, focal)`` of the
    configuration's ``scene`` block; the pose elevations come from
    ``seed``."""
    rng = np.random.default_rng(seed)
    w, h = scene["width"], scene["height"]
    focal = focal_from_angle(w, scene["camera_angle_x"])
    radius = scene["camera_radius"]
    train_c2w = poses(scene["n_train_views"], 0.0, radius, rng)
    test_c2w = poses(scene["n_test_views"], 0.3, radius, rng)
    train = render_views(train_c2w, w, h, focal, radius, device)
    test = render_views(test_c2w, w, h, focal, radius, device)
    return train, train_c2w, test, test_c2w, focal
