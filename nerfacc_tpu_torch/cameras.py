"""OpenCV lens undistortion by Newton iteration.

Port of ``nerfacc_tpu/cameras.py``: the 8-parameter model
{k1, k2, p1, p2, k3, k4, k5, k6} (fewer parameters are padded with zeros)
and the fisheye model {k1, k2, k3, k4}, each undistorted by a fixed number
of elementwise Newton steps, and the forward distortion models, which the
tests use as oracles.  Plain elementwise PyTorch on any device: the JAX
package computes these in ``jnp`` with no Pallas kernel.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

__all__ = [
    "opencv_lens_undistortion",
    "opencv_lens_undistortion_fisheye",
]


def _residual_and_jacobian(x, y, xd, yd, params):
    """Residual of the 8-parameter distortion model at ``(x, y)`` against
    the distorted ``(xd, yd)``, and its Jacobian (``cameras.py:29-52``)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = params.unbind(-1)

    r = x * x + y * y
    alpha = 1.0 + r * (k1 + r * (k2 + r * k3))
    beta = 1.0 + r * (k4 + r * (k5 + r * k6))
    d = alpha / beta

    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd

    alpha_r = k1 + r * (2.0 * k2 + r * (3.0 * k3))
    beta_r = k4 + r * (2.0 * k5 + r * (3.0 * k6))
    d_r = (alpha_r * beta - alpha * beta_r) / (beta * beta)
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r

    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


def opencv_lens_undistortion(uv: Tensor, params: Tensor, eps: float = 1e-6, iters: int = 10) -> Tensor:
    """Undistort OpenCV {k1, k2, p1, p2, k3, k4, k5, k6} distortion by 2-D
    Newton steps (``cameras.py:55-82``).  ``params`` has a trailing size of
    0, 1, 2, 4 or 8 (padded with zeros to 8) and broadcasts against ``uv
    (..., 2)``; a step whose Jacobian determinant is within ``eps`` of 0
    leaves the point where it is."""
    if uv.shape[-1] != 2:
        raise ValueError(f"uv must be (..., 2), got {tuple(uv.shape)}")
    if params.shape[-1] not in (0, 1, 2, 4, 8):
        raise ValueError(f"params must have 0, 1, 2, 4 or 8 entries, got {params.shape[-1]}")
    if params.shape[-1] == 0:
        return uv
    params = torch.nn.functional.pad(params, (0, 8 - params.shape[-1]))
    params = params.expand(uv.shape[:-1] + (8,))
    x0, y0 = uv[..., 0], uv[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        fx, fy, fx_x, fx_y, fy_x, fy_y = _residual_and_jacobian(x, y, x0, y0, params)
        denom = fy_x * fx_y - fx_x * fy_y
        mask = denom.abs() > eps
        safe = torch.where(mask, denom, 1.0)
        x = x + torch.where(mask, (fx * fy_y - fy * fx_y) / safe, 0.0)
        y = y + torch.where(mask, (fy * fx_x - fx * fy_x) / safe, 0.0)
    return torch.stack([x, y], dim=-1)


def opencv_lens_undistortion_fisheye(uv: Tensor, params: Tensor, eps: float = 1e-6, iters: int = 10) -> Tensor:
    """Undistort the OpenCV fisheye {k1, k2, k3, k4} model by scalar Newton
    steps on the angle theta (``cameras.py:85-115``)."""
    if uv.shape[-1] != 2:
        raise ValueError(f"uv must be (..., 2), got {tuple(uv.shape)}")
    if params.shape[-1] != 4:
        raise ValueError(f"params must have 4 entries, got {params.shape[-1]}")
    k1, k2, k3, k4 = params.expand(uv.shape[:-1] + (4,)).unbind(-1)
    u, v = uv[..., 0], uv[..., 1]
    theta_d = torch.sqrt(u * u + v * v).clamp(-math.pi / 2, math.pi / 2)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        t4 = t2 * t2
        t6 = t4 * t2
        t8 = t6 * t2
        num = theta * (1 + k1 * t2 + k2 * t4 + k3 * t6 + k4 * t8) - theta_d
        den = 1 + 3 * k1 * t2 + 5 * k2 * t4 + 7 * k3 * t6 + 9 * k4 * t8
        theta = theta - num / den
    far = theta_d.abs() > eps
    scale = torch.where(far, torch.tan(theta) / torch.where(far, theta_d, 1.0), 1.0)
    return uv * scale[..., None]


def _opencv_lens_distortion(uv: Tensor, params: Tensor) -> Tensor:
    """Forward OpenCV distortion {k1, k2, p1, p2, k3, k4, k5, k6}
    (``cameras.py:123-133``)."""
    k1, k2, p1, p2, k3, k4, k5, k6 = params.unbind(-1)
    u, v = uv[..., 0], uv[..., 1]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    fx = 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    fy = 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return torch.stack([u * radial + fx, v * radial + fy], dim=-1)


def _opencv_lens_distortion_fisheye(uv: Tensor, params: Tensor, eps: float = 1e-10) -> Tensor:
    """Forward OpenCV fisheye distortion {k1, k2, k3, k4}
    (``cameras.py:136-148``)."""
    k1, k2, k3, k4 = params.unbind(-1)
    u, v = uv[..., 0], uv[..., 1]
    r = torch.sqrt(u * u + v * v)
    theta = torch.atan(r)
    theta_d = theta * (1 + k1 * theta**2 + k2 * theta**4 + k3 * theta**6 + k4 * theta**8)
    scale = theta_d / r.clamp(min=eps)
    return uv * scale[..., None]
