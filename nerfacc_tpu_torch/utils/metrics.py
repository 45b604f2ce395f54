"""Image-quality metrics for the eval loops: PSNR, SSIM, MS-SSIM.

Port of ``nerfacc_tpu/utils/metrics.py:28-148``.  Images are float tensors
in ``[0, 1]`` shaped ``(..., H, W, C)``, batched over the leading
dimensions, on any device.  The Gaussian filter runs as two grouped
``conv2d``\\ s with TF32 off, so that the card keeps float32 products.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def psnr(pred: Tensor, target: Tensor, max_val: float = 1.0) -> Tensor:
    mse = torch.mean((pred - target) ** 2, dim=(-3, -2, -1))
    return -10.0 * torch.log10(mse.clamp(min=1e-10) / (max_val**2))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(x**2) / (2 * sigma**2))
    return (g / g.sum()).astype(np.float32)


def _filter2d(img: Tensor, kernel: np.ndarray) -> Tensor:
    """Separable depthwise 2-D filter over ``(..., H, W, C)``, valid padding:
    along H, then along W."""
    batch_shape = img.shape[:-3]
    h, w, c = img.shape[-3:]
    x = img.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    k = torch.from_numpy(kernel).to(img.device, img.dtype)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        x = F.conv2d(x, k.view(1, 1, -1, 1).expand(c, 1, -1, 1), groups=c)
        x = F.conv2d(x, k.view(1, 1, 1, -1).expand(c, 1, 1, -1), groups=c)
    return x.permute(0, 2, 3, 1).reshape(batch_shape + x.shape[2:] + (c,))


def ssim(
    pred: Tensor,
    target: Tensor,
    max_val: float = 1.0,
    win_size: int = 11,
    return_cs: bool = False,
):
    """SSIM (Wang et al. 2004) with the standard 11x11 Gaussian window.

    Channel dim last; returns the mean SSIM over pixels and channels (and the
    contrast-structure term when ``return_cs``, for MS-SSIM).
    """
    kernel = _gaussian_kernel(win_size)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu_p = _filter2d(pred, kernel)
    mu_t = _filter2d(target, kernel)
    mu_pp = _filter2d(pred * pred, kernel)
    mu_tt = _filter2d(target * target, kernel)
    mu_pt = _filter2d(pred * target, kernel)
    var_p = mu_pp - mu_p**2
    var_t = mu_tt - mu_t**2
    cov = mu_pt - mu_p * mu_t
    cs = (2 * cov + c2) / (var_p + var_t + c2)
    s = ((2 * mu_p * mu_t + c1) / (mu_p**2 + mu_t**2 + c1)) * cs
    mean_axes = (-3, -2, -1)
    if return_cs:
        return s.mean(mean_axes), cs.mean(mean_axes)
    return s.mean(mean_axes)


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _downsample2x(img: Tensor) -> Tensor:
    h, w = img.shape[-3] // 2 * 2, img.shape[-2] // 2 * 2
    img = img[..., :h, :w, :]
    return 0.25 * (
        img[..., 0::2, 0::2, :]
        + img[..., 1::2, 0::2, :]
        + img[..., 0::2, 1::2, :]
        + img[..., 1::2, 1::2, :]
    )


def ms_ssim(pred: Tensor, target: Tensor, max_val: float = 1.0, win_size: int = 11) -> Tensor:
    """Multi-scale SSIM (Wang et al. 2003), 5 scales, standard weights.

    Images must be at least ``win_size * 2^4`` on each side for the full 5
    scales; smaller images use as many scales as fit.
    """
    levels = 0
    h, w = pred.shape[-3], pred.shape[-2]
    while levels < 5 and min(h, w) >= win_size:
        levels += 1
        h, w = h // 2, w // 2
    weights = np.asarray(_MSSSIM_WEIGHTS[:levels])
    weights = weights / weights.sum()
    vals = []
    for lvl in range(levels):
        if lvl == levels - 1:
            vals.append(ssim(pred, target, max_val, win_size).clamp(min=0.0))
        else:
            _, cs = ssim(pred, target, max_val, win_size, return_cs=True)
            vals.append(cs.clamp(min=0.0))
            pred = _downsample2x(pred)
            target = _downsample2x(target)
    out = torch.ones_like(vals[0])
    for v, wgt in zip(vals, weights):
        out = out * v ** float(wgt)
    return out


def lpips_or_none(pred: Tensor, target: Tensor) -> Optional[float]:
    """LPIPS-vgg when its weights are available; None otherwise.

    The JAX package builds the ``lpips`` package's network here, which
    fetches VGG weights over the network when they are not cached.  The
    port reads weights only from the local file that
    ``NERFACC_LPIPS_WEIGHTS`` names (see :mod:`~nerfacc_tpu_torch.utils.lpips`),
    and returns None without one; callers fall back to :func:`ms_ssim`.
    """
    from .lpips import lpips

    value, source = lpips(pred, target)
    return value if source == "vgg" else None
