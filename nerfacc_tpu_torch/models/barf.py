"""BARF: learnable SE(3) camera-pose deltas and a coarse-to-fine annealed
positional encoding on a vanilla NeRF.

Port of ``nerfacc_tpu/models/barf.py``: the SE(3) exponential
(``se3_exp``), pose composition, differentiable pixel-centre rays
(``rays_from_pixels``), ``PoseRefine`` (per-camera twists, zeros at the
start), ``AnnealedSinusoidalEncoder`` and ``BARFRadianceField`` on the
port's :class:`~nerfacc_tpu_torch.models.mlp.NerfMLP`.

Rays are made inside the train step from the refined poses, so the pose
deltas get a gradient through the rays' origins and directions.  Every
pose delta starts at exactly zero: ``se3_exp``'s Taylor branch, and its
gradient there, are on the main path.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from .mlp import NerfMLP, SinusoidalEncoder
from .ngp import _norm3

Tensor = torch.Tensor


def _hat(w: Tensor) -> Tensor:
    """Skew-symmetric matrix ``(..., 3, 3)`` of ``(..., 3)``."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def se3_exp(xi: Tensor) -> Tensor:
    """SE(3) exponential: a ``(..., 6)`` twist ``[omega | v]`` to a ``(..., 3,
    4)`` rigid transform, with Taylor terms below ``|omega|^2 = 1e-8``
    (``barf.py:44-63``)."""
    w, v = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # (..., 1, 1)
    small = t2 < 1e-8
    # The denominators are clamped before the where, so the branch that is
    # not taken stays finite and its zero cotangent gives no NaN.
    t2s = torch.maximum(t2, t2.new_tensor(1e-12))
    t = torch.sqrt(t2s)
    A = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    C = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (1.0 - A) / t2s)
    W = _hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    trans = (V @ v[..., None])[..., 0]
    return torch.cat([R, trans[..., None]], dim=-1)


def compose_pose(delta: Tensor, c2w: Tensor) -> Tensor:
    """``exp(xi) @ T_nominal`` for ``(..., 3, 4)`` delta and nominal poses
    (``barf.py:66-71``)."""
    R = delta[..., :3] @ c2w[..., :3]
    t = (delta[..., :3] @ c2w[..., 3:4])[..., 0] + delta[..., 3]
    return torch.cat([R, t[..., None]], dim=-1)


def rays_from_pixels(x: Tensor, y: Tensor, K: Tensor, c2w: Tensor, opengl: bool = True) -> Tuple[Tensor, Tensor]:
    """Pixel-centre rays ``(origins, viewdirs)`` from pixel columns ``x``,
    rows ``y``, intrinsics ``K (3, 3)`` and per-pixel poses ``c2w (..., 3,
    4)`` (``barf.py:74-95``), differentiable in ``c2w``.

    The camera direction is rotated as the JAX package rounds it (each
    product rounded, then summed in axis order) and its norm is
    :func:`~nerfacc_tpu_torch.models.ngp._norm3`'s, which the card and the
    CPU round alike (a vector-norm reduction on the card rounds otherwise).
    """
    sign = -1.0 if opengl else 1.0
    dirs = torch.stack(
        [(x + 0.5 - K[0, 2]) / K[0, 0], (y + 0.5 - K[1, 2]) / K[1, 1] * sign, sign * torch.ones_like(x)],
        dim=-1,
    )
    p = dirs[..., None, :] * c2w[..., :3, :3]
    d = p[..., 0] + p[..., 1] + p[..., 2]
    viewdirs = d / _norm3(d)
    return c2w[..., :3, 3].expand(viewdirs.shape), viewdirs


class PoseRefine(nn.Module):
    """Per-camera SE(3) twists (``barf.py:98-113``): ``pose_deltas (n_cams,
    6)``, zeros; ``forward(cam_ids, c2w_nominal)`` gives the refined ``(N,
    3, 4)`` poses of ``cam_ids`` from their nominal poses.  The rows are
    read with ``index_select``, whose backward is one ``index_add_``."""

    def __init__(self, n_cams: int, *, device: Union[str, torch.device] = "cuda") -> None:
        super().__init__()
        self.pose_deltas = nn.Parameter(torch.zeros((n_cams, 6), device=resolve_device(device)))

    def forward(self, cam_ids: Tensor, c2w_nominal: Tensor) -> Tensor:
        return compose_pose(se3_exp(torch.index_select(self.pose_deltas, 0, cam_ids.long())), c2w_nominal)


class AnnealedSinusoidalEncoder(SinusoidalEncoder):
    """BARF's coarse-to-fine positional encoding (``barf.py:116-152``):
    :class:`~nerfacc_tpu_torch.models.mlp.SinusoidalEncoder`'s features,
    frequency ``k`` weighted by ``(1 - cos(pi clip(alpha L - k, 0, 1))) /
    2`` for ``alpha`` in ``[0, 1]``."""

    def forward(self, x: Tensor, alpha) -> Tensor:
        latent = super().forward(x)
        if self.max_deg == self.min_deg:
            return latent
        L = self.max_deg - self.min_deg
        alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
        k = torch.arange(L, dtype=x.dtype, device=x.device)
        win = 0.5 * (1.0 - torch.cos(math.pi * torch.clamp(alpha * L - k, 0.0, 1.0)))
        win = win[:, None].expand(L, self.x_dim).reshape(-1)
        n_id = self.x_dim if self.use_identity else 0
        return torch.cat([latent[..., :n_id], latent[..., n_id:] * torch.cat([win, win], dim=-1)], dim=-1)


class BARFRadianceField(nn.Module):
    """A vanilla NeRF with annealed encoders (``barf.py:155-196``), degree 10
    for positions and 4 for view directions; ``alpha`` in ``[0, 1]`` is the
    annealing progress.  ``forward(x, condition, alpha)`` returns
    ``(sigmoid(rgb), relu(sigma))``."""

    def __init__(
        self,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: int = 4,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        pos_deg: int = 10,
        view_deg: int = 4,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.posi_encoder = AnnealedSinusoidalEncoder(3, 0, pos_deg)
        self.view_encoder = AnnealedSinusoidalEncoder(3, 0, view_deg)
        self.mlp = NerfMLP(
            self.posi_encoder.latent_dim, self.view_encoder.latent_dim, net_depth=net_depth, net_width=net_width,
            skip_layer=skip_layer, net_depth_condition=net_depth_condition,
            net_width_condition=net_width_condition, device=device, generator=generator,
        )

    def query_opacity(self, x: Tensor, step_size: float, alpha=1.0) -> Tensor:
        return self.query_density(x, alpha) * step_size

    def query_density(self, x: Tensor, alpha=1.0) -> Tensor:
        return torch.relu(self.mlp.query_density(self.posi_encoder(x, alpha)))

    def forward(self, x: Tensor, condition: Optional[Tensor] = None, alpha=1.0):
        x = self.posi_encoder(x, alpha)
        if condition is not None:
            condition = self.view_encoder(condition, alpha)
        rgb, sigma = self.mlp(x, condition=condition)
        return torch.sigmoid(rgb), torch.relu(sigma)
