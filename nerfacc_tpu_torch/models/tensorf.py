"""TensoRF (VM decomposition) and K-Planes radiance fields.

Port of ``nerfacc_tpu/models/tensorf.py``: bilinear plane and linear line
samples (``_interp_plane``, ``_interp_line``), ``TensoRFRadianceField`` (sums
of plane x line products, a basis matrix and a colour MLP) and
``KPlanesRadianceField`` (products of plane features, static or with three
space-time planes).

Each plane or line sample is four (or two) row gathers of an ``(R * R, C)``
view of the parameter and a weighted sum, as the JAX package's
``jnp.take``; a gather's backward is one ``index_add_`` into the
parameter's gradient (:func:`take_rows`), not the backward of advanced
indexing, which adds the duplicates of one index one after another.  No
Pallas kernel is involved, in the JAX package or here.

Parameters are named as flax names them (``dp0`` .. ``al2``, ``sp0`` ..
``tp2``; ``rgb_mlp.0`` is flax's ``rgb_mlp/layers_0``), so
:func:`~nerfacc_tpu_torch.convert.field_from_jax` maps them one to
one.  Flax infers the colour MLP's input width from its first call: the
port fixes it at construction (TensoRF's at ``appearance_dim + 3``;
K-Planes' through ``use_viewdirs``, 3 more inputs when True).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ..device import resolve_device
from .ngp import _lecun_linear, trunc_exp

Tensor = torch.Tensor

# Axis pairs of the three planes (matij) and their complementary lines.
_PLANE_AXES = ((0, 1), (0, 2), (1, 2))
_LINE_AXES = (2, 1, 0)


def clip(x: Tensor, lo: float, hi: float) -> Tensor:
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``, whose gradient is
    halved where ``x`` equals a bound (``clamp`` passes all of it)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


class _TakeRows(torch.autograd.Function):
    """``table.index_select(0, idx)``; its backward ``index_add_``s the
    rows' cotangent into a zero gradient inside a ``record_function``
    range named ``label``, so a profile attributes it."""

    @staticmethod
    def forward(ctx, table, idx, label):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.label = table.shape[0], label
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        with record_function(ctx.label):
            return g.new_zeros((ctx.rows,) + g.shape[1:]).index_add_(0, idx, g), None, None


def take_rows(table: Tensor, idx: Tensor, label: str) -> Tensor:
    """Rows ``idx`` (any shape, int64) of a 2-D ``table``: ``idx.shape +
    (C,)``.  The backward's range is ``label`` (``plane_gather_backward``,
    ``line_gather_backward``, ``voxel_gather_backward``)."""
    return _TakeRows.apply(table, idx.reshape(-1), label).reshape(idx.shape + table.shape[1:])


def _corner(x: Tensor, r: int) -> Tuple[Tensor, Tensor, Tensor]:
    """``x`` in cell units on ``r`` rows: its lower row, the next row
    (clamped to the last) and the weight ``x - x0`` in float32."""
    x0 = torch.floor(x)
    i0 = x0.long()
    return i0, torch.clamp(i0 + 1, max=r - 1), x - x0


def _interp_plane(plane: Tensor, u: Tensor, v: Tensor) -> Tensor:
    """Bilinear sample of ``plane (R0, R1, C)`` at ``(u, v)`` in ``[0, 1]``:
    ``(..., C)`` (``tensorf.py:33-58``)."""
    r0, r1, c = plane.shape
    x0, x1, wx = _corner(clip(u * (r0 - 1), 0, r0 - 1), r0)
    y0, y1, wy = _corner(clip(v * (r1 - 1), 0, r1 - 1), r1)
    wx, wy = wx[..., None], wy[..., None]
    flat = plane.reshape(r0 * r1, c)

    def take(idx):
        return take_rows(flat, idx, "plane_gather_backward")

    return (
        take(x0 * r1 + y0) * (1 - wx) * (1 - wy)
        + take(x0 * r1 + y1) * (1 - wx) * wy
        + take(x1 * r1 + y0) * wx * (1 - wy)
        + take(x1 * r1 + y1) * wx * wy
    )


def _interp_line(line: Tensor, u: Tensor) -> Tensor:
    """Linear sample of ``line (R, C)`` at ``u`` in ``[0, 1]``: ``(..., C)``
    (``tensorf.py:61-68``)."""
    r = line.shape[0]
    x0, x1, w = _corner(clip(u * (r - 1), 0, r - 1), r)
    w = w[..., None]
    return take_rows(line, x0, "line_gather_backward") * (1 - w) + take_rows(line, x1, "line_gather_backward") * w


def _unit_box(x: Tensor, aabb: Tensor) -> Tuple[Tensor, Tensor]:
    """Positions in the box's ``[0, 1]^3`` and the mask of those strictly
    inside."""
    u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    return u, ((u > 0.0) & (u < 1.0)).all(dim=-1)


def _param(shape, draw, generator) -> nn.Parameter:
    return nn.Parameter(draw(shape, generator))


def _normal(std: float):
    return lambda shape, g: torch.randn(shape, generator=g) * std


def _uniform(scale: float):
    # flax's uniform(scale) draws on [0, scale).
    return lambda shape, g: torch.rand(shape, generator=g) * scale


class TensoRFRadianceField(nn.Module):
    """TensoRF-VM (``tensorf.py:71-150``): density and appearance as sums of
    plane x line products; density ``softplus(sigma + 0.1)``, zero outside
    the box; colour ``sigmoid(rgb_mlp([basis_mat(app), direction]))``."""

    def __init__(
        self,
        aabb: Sequence[float],
        resolution: int = 128,
        density_components: int = 8,
        appearance_components: int = 24,
        appearance_dim: int = 27,
        mlp_width: int = 128,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("aabb", torch.tensor(list(aabb), dtype=torch.float32), persistent=False)
        R, init = resolution, _normal(0.1)
        for i in range(3):
            setattr(self, f"dp{i}", _param((R, R, density_components), init, generator))
        for i in range(3):
            setattr(self, f"dl{i}", _param((R, density_components), init, generator))
        for i in range(3):
            setattr(self, f"ap{i}", _param((R, R, appearance_components), init, generator))
        for i in range(3):
            setattr(self, f"al{i}", _param((R, appearance_components), init, generator))
        self.basis_mat = _lecun_linear(3 * appearance_components, appearance_dim, generator, bias=False)
        self.rgb_mlp = nn.Sequential(
            _lecun_linear(appearance_dim + 3, mlp_width, generator),
            nn.ReLU(),
            _lecun_linear(mlp_width, mlp_width, generator),
            nn.ReLU(),
            _lecun_linear(mlp_width, 3, generator),
        )
        self.to(device)

    def _planes(self, kind: str) -> list:
        return [getattr(self, f"{kind}{i}") for i in range(3)]

    def _vm_features(self, u: Tensor, planes, lines) -> list:
        us = [u[..., 0], u[..., 1], u[..., 2]]
        return [
            _interp_plane(planes[i], us[a], us[b]) * _interp_line(lines[i], us[l])
            for i, ((a, b), l) in enumerate(zip(_PLANE_AXES, _LINE_AXES))
        ]

    def _density(self, u: Tensor, selector: Tensor) -> Tensor:
        feats = self._vm_features(u, self._planes("dp"), self._planes("dl"))
        sigma_feat = sum(f.sum(-1) for f in feats)
        # The JAX package multiplies by the selector, which XLA makes a
        # select: no inf * 0 outside the box.
        return torch.where(selector[..., None], F.softplus(sigma_feat + 0.1)[..., None], 0.0)

    def query_density(self, x: Tensor, return_feat: bool = False):
        u, selector = _unit_box(x, self.aabb)
        density = self._density(clip(u, 0.0, 1.0), selector)
        return (density, None) if return_feat else density

    def _query_rgb(self, u: Tensor, direction: Optional[Tensor]) -> Tensor:
        feats = torch.cat(self._vm_features(u, self._planes("ap"), self._planes("al")), dim=-1)
        h = self.basis_mat(feats)
        if direction is not None:
            h = torch.cat([h, direction], dim=-1)
        return torch.sigmoid(self.rgb_mlp(h))

    def forward(self, x: Tensor, directions: Optional[Tensor] = None):
        u, selector = _unit_box(x, self.aabb)
        u = clip(u, 0.0, 1.0)
        return self._query_rgb(u, directions), self._density(u, selector)


class KPlanesRadianceField(nn.Module):
    """K-Planes (``tensorf.py:153-223``): the product of ``plane + 0.5``
    over the three space planes (and with ``dynamic`` the three space-time
    planes at ``t``), a density head ``trunc_exp(sigma_head(feat) - 1)``,
    zero outside the box, and ``sigmoid(rgb_mlp([feat, directions]))``.

    ``forward(x, t, directions)`` takes its arguments in the JAX class's
    order: a caller that passes ``(x, d)`` puts ``d`` in ``t``, which a
    static field ignores, and gets a view-independent colour from an MLP of
    ``n_features`` inputs (``use_viewdirs=False``), as the JAX example's
    ``field.apply(params, x, d)`` does.
    """

    def __init__(
        self,
        aabb: Sequence[float],
        resolution: int = 128,
        time_resolution: int = 32,
        n_features: int = 32,
        dynamic: bool = False,
        mlp_width: int = 128,
        use_viewdirs: bool = True,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.dynamic = dynamic
        self.register_buffer("aabb", torch.tensor(list(aabb), dtype=torch.float32), persistent=False)
        R, C, init = resolution, n_features, _uniform(0.2)
        for i in range(3):
            setattr(self, f"sp{i}", _param((R, R, C), init, generator))
        if dynamic:
            for i in range(3):
                setattr(self, f"tp{i}", _param((R, time_resolution, C), init, generator))
        self.sigma_head = _lecun_linear(C, 1, generator)
        self.rgb_mlp = nn.Sequential(
            _lecun_linear(C + (3 if use_viewdirs else 0), mlp_width, generator),
            nn.ReLU(),
            _lecun_linear(mlp_width, 3, generator),
        )
        self.to(device)

    def _features(self, u: Tensor, t: Optional[Tensor]) -> Tensor:
        us = [u[..., 0], u[..., 1], u[..., 2]]
        feat = 1.0
        for i, (a, b) in enumerate(_PLANE_AXES):
            feat = feat * (_interp_plane(getattr(self, f"sp{i}"), us[a], us[b]) + 0.5)
        if self.dynamic:
            if t is None:
                raise ValueError("dynamic K-Planes needs timestamps")
            tt = clip(t[..., 0], 0.0, 1.0)
            for i in range(3):
                feat = feat * (_interp_plane(getattr(self, f"tp{i}"), us[i], tt) + 0.5)
        return feat

    def _feat_sigma(self, x: Tensor, t: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
        u, selector = _unit_box(x, self.aabb)
        feat = self._features(clip(u, 0.0, 1.0), t)
        return feat, torch.where(selector[..., None], trunc_exp(self.sigma_head(feat) - 1.0), 0.0)

    def query_density(self, x: Tensor, t: Optional[Tensor] = None) -> Tensor:
        return self._feat_sigma(x, t)[1]

    def forward(self, x: Tensor, t: Optional[Tensor] = None, directions: Optional[Tensor] = None):
        feat, sigma = self._feat_sigma(x, t)
        h = feat if directions is None else torch.cat([feat, directions], dim=-1)
        return torch.sigmoid(self.rgb_mlp(h)), sigma
