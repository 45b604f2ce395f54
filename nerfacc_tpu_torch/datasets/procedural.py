"""The procedural analytic scene ("jelly" blobs) and its exact renders.

Port of ``nerfacc_tpu/datasets/procedural.py``: an analytic emissive
density field rendered to RGBA images by dense ray marching, which gives the
repository a training target that needs no download, and its dynamic
variant, whose blobs orbit with time (the T-NeRF target).  The views are
rendered on ``device``; poses and rays are made in numpy from the same seed
as the JAX package's, so both packages render from the same rays.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple, Union

import numpy as np
import torch

from ..device import resolve_device
from .utils import camera_rays

Tensor = torch.Tensor
Scene = Callable[[Tensor], Tuple[Tensor, Tensor]]  # points (..., 3) -> (rgb (..., 3), density (...))

# Scene definition: gaussian-ish blobs (center, radius, density, rgb).
_BLOBS = np.array(
    [
        # cx, cy, cz, radius, density, r, g, b
        [0.0, 0.0, 0.0, 0.45, 40.0, 0.85, 0.25, 0.2],
        [0.5, 0.3, -0.2, 0.3, 30.0, 0.2, 0.7, 0.9],
        [-0.5, -0.2, 0.35, 0.25, 50.0, 0.95, 0.8, 0.2],
        [0.1, -0.5, -0.4, 0.2, 60.0, 0.3, 0.9, 0.35],
        [-0.25, 0.55, 0.1, 0.22, 45.0, 0.7, 0.4, 0.9],
    ],
    dtype=np.float32,
)

# Rays a device call renders at once (JAX ``generate_dataset``'s chunk).
CHUNK = 65536
NEAR, FAR = 1.3, 3.7  # make_loaders' planes, radius 2.5 -+ 1.2


def _blob_weights(x: Tensor) -> Tensor:
    """Each blob's ``density * max(0, 1 - (dist / r)^2)^2`` at ``x`` (..., 3),
    shape (..., B).  The squared distance is summed over x, y, z one axis at a
    time, which keeps the (..., B, 3) differences out of memory."""
    b = torch.from_numpy(_BLOBS).to(x.device)
    dist2 = sum((x[..., i : i + 1] - b[:, i]) ** 2 for i in range(3))
    u = (1.0 - dist2 / (b[:, 3] ** 2)).clamp(min=0.0)
    return b[:, 4] * u * u


def scene_density(x: Tensor) -> Tensor:
    """Analytic density at points ``x`` (..., 3)."""
    return _blob_weights(x).sum(-1)


def scene_rgb_density(x: Tensor, detail: float = 0.0) -> Tuple[Tensor, Tensor]:
    """Analytic ``(rgb (..., 3), density (...))`` at points ``x`` (..., 3).

    ``detail > 0`` adds multi-octave colour texture and density ripples
    whose finest wavelength (about 0.03 scene units, 9 pixels at 800x800
    from the default camera ring) is beyond the coarse hash levels, so that
    table capacity and the fine levels matter (the JAX package's
    reference-class quality scene); ``detail=0`` is the smooth-blob scene.
    """
    rgb = torch.from_numpy(_BLOBS[:, 5:8]).to(x.device)
    w = _blob_weights(x)  # (..., B)
    sigma = w.sum(-1)
    weighted = sum(w[..., j : j + 1] * rgb[j] for j in range(rgb.shape[0]))
    colors = weighted / sigma[..., None].clamp(min=1e-8)
    # subtle position-dependent shading so views differ
    xx, yy, zz = x[..., :1], x[..., 1:2], x[..., 2:3]
    shade = 0.75 + 0.25 * torch.sin(4.0 * xx) * torch.cos(4.0 * yy)
    if detail > 0.0:
        octaves = (
            0.22 * torch.sin(20.0 * xx + 1.0) * torch.sin(20.0 * zz)
            + 0.14 * torch.sin(55.0 * yy + 2.0) * torch.cos(55.0 * zz + 1.0)
            + 0.09 * torch.sin(200.0 * xx + 0.7) * torch.sin(200.0 * yy + 1.3)
        )
        shade = shade + detail * octaves
        # Density ripples carve fine geometric structure into the blob
        # surfaces (high-frequency opacity edges).
        sigma = sigma * (
            1.0
            + 0.35
            * detail
            * torch.sin(40.0 * xx[..., 0] + 2.0 * yy[..., 0])
            * torch.sin(40.0 * zz[..., 0])
        )
    return (colors * shade).clamp(0.0, 1.0), sigma


@torch.no_grad()
def _render_pose_chunk(
    origins: Tensor, viewdirs: Tensor, near: float, far: float, scene: Scene, n_steps: int = 512,
) -> Tuple[Tensor, Tensor]:
    """``(color (n, 3), opacity (n, 1))`` of rays ``(n, 3)`` through
    ``scene(x) -> (rgb, density)``: ``n_steps`` midpoint samples between
    ``near`` and ``far``, exclusive-cumsum transmittance."""
    t = torch.from_numpy(np.linspace(near, far, n_steps + 1).astype(np.float32)).to(origins.device)
    t0, t1 = t[:-1], t[1:]
    tm = (t0 + t1) / 2.0
    x = origins[:, None, :] + tm[None, :, None] * viewdirs[:, None, :]
    rgbs, sigmas = scene(x)
    sdt = sigmas * (t1 - t0)[None, :]
    alphas = 1.0 - torch.exp(-sdt)
    trans = torch.exp(-torch.cumsum(torch.nn.functional.pad(sdt, (1, 0))[:, :-1], dim=-1))
    weights = trans * alphas
    color = (weights[..., None] * rgbs).sum(-2)
    opacity = weights.sum(-1, keepdim=True)
    return color, opacity


def render_pixels(
    c2w: np.ndarray, K: np.ndarray, x: np.ndarray, y: np.ndarray, radius: float = 2.5,
    detail: float = 0.0, *, device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """uint8 RGBA ``(n, 4)`` of pixels ``(x, y)`` (``(n,)`` each) of the camera
    ``c2w`` with intrinsics ``K``, rendered on ``device`` in chunks of
    :data:`CHUNK` rays between ``radius -+ 1.2``.

    The JAX package pads the last chunk with the last ray to keep one
    compiled shape; eager PyTorch has no shape to keep and each ray is
    rendered alone, so the last chunk is not padded.
    """
    return _render_pixels(c2w, K, x, y, radius, lambda p: scene_rgb_density(p, detail), resolve_device(device))


def _render_pixels(c2w, K, x, y, radius: float, scene: Scene, device: torch.device) -> np.ndarray:
    """:func:`render_pixels` through ``scene(x) -> (rgb, density)``."""
    o, d = camera_rays(x.astype(np.float32), y.astype(np.float32), K, c2w[:3, :4], opengl=True)
    o, d = torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)
    parts = [
        torch.cat(_render_pose_chunk(o[j : j + CHUNK], d[j : j + CHUNK], radius - 1.2, radius + 1.2, scene), -1)
        for j in range(0, o.shape[0], CHUNK)
    ]
    rgba = torch.cat(parts).cpu().numpy()
    return (np.clip(rgba, 0, 1) * 255).astype(np.uint8)


def intrinsics(width: int, height: int) -> np.ndarray:
    """The scene's camera: focal ``0.9 * width``, centred."""
    focal = 0.9 * width
    return np.array([[focal, 0, width / 2], [0, focal, height / 2], [0, 0, 1]], dtype=np.float32)


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Blender-style look-at-origin camera pose (OpenGL convention), 4x4."""
    trans = np.eye(4, dtype=np.float32)
    trans[2, 3] = radius
    rot_phi = np.eye(4, dtype=np.float32)
    rot_phi[1, 1] = np.cos(phi)
    rot_phi[1, 2] = -np.sin(phi)
    rot_phi[2, 1] = np.sin(phi)
    rot_phi[2, 2] = np.cos(phi)
    rot_theta = np.eye(4, dtype=np.float32)
    rot_theta[0, 0] = np.cos(theta)
    rot_theta[0, 2] = -np.sin(theta)
    rot_theta[2, 0] = np.sin(theta)
    rot_theta[2, 2] = np.cos(theta)
    return rot_theta @ rot_phi @ trans


def generate_dataset(
    n_train: int = 24,
    n_test: int = 4,
    width: int = 128,
    height: int = 128,
    radius: float = 2.5,
    seed: int = 0,
    detail: float = 0.0,
    *,
    device: Union[str, torch.device] = "cuda",
):
    """Render the analytic scene from poses on a sphere, on ``device``.

    Returns ``(train_images, train_c2w, test_images, test_c2w, focal)``:
    uint8 RGBA images and float32 poses in numpy, as the JAX package's
    ``generate_dataset`` returns them for the same ``seed``.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    K = intrinsics(width, height)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    xx, yy = xx.reshape(-1), yy.reshape(-1)

    def render_split(n_views, phase):
        images, poses = [], []
        for i in range(n_views):
            theta = 2 * np.pi * (i / n_views) + phase
            phi = -np.pi / 5 - 0.4 * rng.random()
            c2w = pose_spherical(theta, phi, radius)
            rgba = render_pixels(c2w, K, xx, yy, radius, detail, device=device)
            images.append(rgba.reshape(height, width, 4))
            poses.append(c2w)
        return np.stack(images), np.stack(poses)

    train_images, train_c2w = render_split(n_train, 0.0)
    test_images, test_c2w = render_split(n_test, 0.3)
    return train_images, train_c2w, test_images, test_c2w, 0.9 * width


def scene_rgb_density_t(x: Tensor, t: Union[float, Tensor]) -> Tuple[Tensor, Tensor]:
    """The time-animated scene (``procedural.py:200-228``): the blobs'
    centres turn about the z axis by ``0.6 sin(2 pi t)`` at time ``t`` in
    ``[0, 1]`` (a number, or a tensor of ``x.shape[:-1]``).  Returns
    ``(rgb (..., 3), density (...))``, without the static scene's shading."""
    b = torch.from_numpy(_BLOBS).to(x.device)
    ang = 0.6 * torch.sin(2 * math.pi * torch.as_tensor(t, dtype=x.dtype, device=x.device))[..., None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    cx = cos * b[:, 0] - sin * b[:, 1]
    cy = sin * b[:, 0] + cos * b[:, 1]
    dist2 = (x[..., 0:1] - cx) ** 2 + (x[..., 1:2] - cy) ** 2 + (x[..., 2:3] - b[:, 2]) ** 2
    u = (1.0 - dist2 / (b[:, 3] ** 2)).clamp(min=0.0)
    w = b[:, 4] * u * u  # (..., B)
    sigma = w.sum(-1)
    rgb = b[:, 5:8]
    colors = sum(w[..., j : j + 1] * rgb[j] for j in range(rgb.shape[0])) / sigma[..., None].clamp(min=1e-8)
    return colors.clamp(0.0, 1.0), sigma


def make_dynamic_loaders(
    num_rays: int = 1024,
    width: int = 96,
    height: int = 96,
    n_train: int = 24,
    n_test: int = 2,
    radius: float = 2.5,
    *,
    device: Union[str, torch.device] = "cuda",
):
    """Procedural dynamic train and test
    :class:`~nerfacc_tpu_torch.datasets.dnerf_synthetic.SubjectLoader`\\ s
    (``procedural.py:250-305``): view ``i`` of a split shows time ``i /
    (n - 1)`` from the pose ring, rendered on ``device`` in chunks of
    :data:`CHUNK` rays; near 1.3, far 3.7.  The pose jitter comes from numpy's
    ``default_rng(0)``, as in the JAX package."""
    from .dnerf_synthetic import SubjectLoader as DynLoader

    device = resolve_device(device)
    K = intrinsics(width, height)
    rng = np.random.default_rng(0)
    xx, yy = np.meshgrid(np.arange(width), np.arange(height))
    xx, yy = xx.reshape(-1), yy.reshape(-1)

    def render_split(n_views, phase):
        images, poses, times = [], [], []
        for i in range(n_views):
            t = float(np.float32(i / max(n_views - 1, 1)))
            theta = 2 * np.pi * (i / n_views) + phase
            phi = -np.pi / 5 - 0.4 * rng.random()
            c2w = pose_spherical(theta, phi, radius)
            rgba = _render_pixels(c2w, K, xx, yy, radius, lambda p: scene_rgb_density_t(p, t), device)
            images.append(rgba.reshape(height, width, 4))
            poses.append(c2w)
            times.append(t)
        return np.stack(images), np.stack(poses), np.asarray(times, np.float32)

    tr_im, tr_c2w, tr_t = render_split(n_train, 0.0)
    te_im, te_c2w, te_t = render_split(n_test, 0.3)
    common = dict(focal=0.9 * width, near=NEAR, far=FAR, device=device)
    train = DynLoader(split="train", num_rays=num_rays, images=tr_im, camtoworlds=tr_c2w, timestamps=tr_t, **common)
    test = DynLoader(split="test", images=te_im, camtoworlds=te_c2w, timestamps=te_t, **common)
    return train, test


def make_loaders(
    num_rays: int = 1024,
    width: int = 128,
    height: int = 128,
    n_train: int = 24,
    n_test: int = 2,
    detail: float = 0.0,
    *,
    device: Union[str, torch.device] = "cuda",
):
    """Procedural train and test
    :class:`~nerfacc_tpu_torch.datasets.nerf_synthetic.SubjectLoader`\\ s
    (aabb about ``[-1, 1]^3``, near 1.3, far 3.7), rendered and batched on
    ``device``.  ``detail=1.0`` selects the textured scene (see
    :func:`scene_rgb_density`)."""
    from .nerf_synthetic import SubjectLoader

    tr_im, tr_c2w, te_im, te_c2w, focal = generate_dataset(
        n_train=n_train, n_test=n_test, width=width, height=height, detail=detail, device=device,
    )
    common = dict(focal=focal, near=NEAR, far=FAR, device=device)
    train = SubjectLoader(split="train", num_rays=num_rays, images=tr_im, camtoworlds=tr_c2w, **common)
    test = SubjectLoader(split="test", images=te_im, camtoworlds=te_c2w, **common)
    return train, test
