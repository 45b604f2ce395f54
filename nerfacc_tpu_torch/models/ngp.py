"""Instant-NGP fields: a hash grid plus small MLPs.

Port of ``nerfacc_tpu/models/ngp.py:39-304``: the radiance field and the
proposal nets' density field, each with any of the five hash encoders
(``encoder_type``: the tcnn-parity ``hash`` and ``soa``, the corner-per-row
``fused``, ``folded`` and ``grouped``).
Parameters are initialised as flax initialises them (``lecun_normal``
kernels, i.e. a normal truncated at two standard deviations; zero biases;
the table uniform in ``[0, 2e-4)``) from a ``torch.Generator`` on the CPU, so
one seed gives the same weights on every device.

The MLPs are ``nn.Linear`` layers with float32 parameters.  With
``compute_dtype=torch.bfloat16`` the encoder's combine and both MLPs
compute in bf16 from those parameters, as flax ``nn.Dense(dtype=bf16)``
does, and the density and colour activations are applied in float32.  In
float32, products run in full float32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default, and
what ``chip_smoke.py`` sets); TF32 would keep about three decimal digits.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .encoding import HashGridEncoder, spherical_harmonics_deg4
from .hash_soa import (
    HashGridEncoderFolded,
    HashGridEncoderFused,
    HashGridEncoderGrouped,
    HashGridEncoderSoA,
    TABLE_GRADS,
    paired_safe_level_count,
)

Tensor = torch.Tensor

ENCODERS = {
    "hash": HashGridEncoder,
    "soa": HashGridEncoderSoA,
    "fused": HashGridEncoderFused,
    "folded": HashGridEncoderFolded,
    "grouped": HashGridEncoderGrouped,
}
# Encoders that store a cell's 8 corners in one row: their rows a level drop
# 8x, so that the parameter count is the reference layout's (2^19 entries x
# 2 features == 2^16 rows x 8 corners x 2).
_CORNER_ROWS = ("fused", "folded", "grouped")


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def trunc_exp(x: Tensor) -> Tensor:
    """exp whose gradient clamps its input at 15 (``ngp.py:39-53``)."""
    return _TruncExp.apply(x)


def contract_tanh(x: Tensor, aabb: Tensor) -> Tensor:
    """Per-axis tanh contraction to ``[0, 1]^3`` (``ngp.py:56-62``); the box
    maps to ``[0.5 - tanh(0.5) / 2, 0.5 + tanh(0.5) / 2]^3``."""
    u = (x - aabb[..., :3]) / (aabb[..., 3:] - aabb[..., :3]) - 0.5
    return torch.tanh(u) * 0.5 + 0.5


def contract_tanh_inv(x: Tensor, aabb: Tensor) -> Tensor:
    """Inverse of :func:`contract_tanh` (``ngp.py:65-69``)."""
    u = torch.atanh((x * 2.0 - 1.0).clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    return (u + 0.5) * (aabb[..., 3:] - aabb[..., :3]) + aabb[..., :3]


def _norm3(x: Tensor) -> Tensor:
    """``|x|`` over the last axis of 3, ``keepdim``, as XLA and PyTorch's CPU
    norm round it: ``sqrt(fma(z, z, fma(y, y, x * x)))`` in float32, each
    step correctly rounded.  Each fused multiply-add is a float64 multiply
    and add rounded to float32 (the same result but where the float64 sum
    falls on a float32 tie), and the root is taken in float64 and rounded,
    so the card, whose norm reduction rounds otherwise, gets the CPU's
    value bit for bit: one ulp there moves a contracted position across a
    cell face of the fused encoder, whose features jump there."""
    xd = x.double()
    acc = (xd[..., 0:1] * xd[..., 0:1]).float()
    for i in (1, 2):
        acc = (xd[..., i : i + 1] * xd[..., i : i + 1] + acc.double()).float()
    return torch.sqrt(acc.double()).float()


def contract_to_unisphere(
    x: Tensor, aabb: Tensor, ord: Union[int, float, None] = 2, eps: float = 1e-6
) -> Tensor:
    """MipNeRF-360 scene contraction of ``(..., 3)`` points to ``[0, 1]^3``
    (``ngp.py:72-82``), with the magnitude the vector norm of order ``ord``
    (``jnp.linalg.norm``'s: 2 or None, 1, ``inf``, ``-inf``, 0 or any other
    p).  The 2-norm is :func:`_norm3`, the same on the card as on the CPU."""
    x = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    x = x * 2 - 1  # aabb at [-1, 1]
    if ord is None or ord == 2:
        mag = _norm3(x)
    else:
        mag = torch.linalg.vector_norm(x, ord=ord, dim=-1, keepdim=True)
    mag = mag.clamp(min=eps)
    contracted = (2 - 1 / mag) * (x / mag)
    x = torch.where(mag > 1, contracted, x)
    return x / 4 + 0.5


def _lecun_linear(
    fan_in: int, fan_out: int, generator: Optional[torch.Generator], bias: bool = True
) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out, bias=bias, device="cpu")
    # flax variance_scaling(1, "fan_in", "truncated_normal"): the std of a
    # unit normal truncated to [-2, 2] is 0.87962566103423978.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(
            layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator
        )
        if bias:
            layer.bias.zero_()
    return layer


def _mlp(seq: nn.Sequential, h: Tensor, cdt: Optional[torch.dtype]) -> Tensor:
    """``seq(h)``, with each layer in ``cdt`` if one is set (flax
    ``nn.Dense(dtype=cdt)`` on float32 parameters)."""
    if cdt is None:
        return seq(h)
    h = h.to(cdt)
    for layer in seq:
        if isinstance(layer, nn.Linear):
            h = F.linear(h, layer.weight.to(cdt), layer.bias.to(cdt))
        else:
            h = layer(h)
    return h


def _density(h: Tensor, selector: Tensor) -> Tensor:
    """``trunc_exp(h - 1)`` in float32 where ``selector``, else 0.  The JAX
    package writes ``trunc_exp(h - 1) * selector``, which XLA turns into a
    select, so a density that overflows to inf outside the box is 0 there,
    not inf * 0 = NaN."""
    return torch.where(selector[..., None], trunc_exp(h.to(torch.float32) - 1), 0.0)


def _unit_box_soa(x, aabb: Tensor, unbounded: bool):
    """:func:`_unit_box` on an ``(xs, ys, zs)`` tuple, each component by
    itself (``ngp.py:190-216``): the contraction's norm is ``sqrt(x x + y y
    + z z)`` as written there."""
    xs, ys, zs = x
    lo, hi = aabb[:3], aabb[3:]
    u = [(c - lo[i]) / (hi[i] - lo[i]) for i, c in enumerate((xs, ys, zs))]
    if unbounded:
        c = [v * 2 - 1 for v in u]
        mag = torch.sqrt(c[0] * c[0] + c[1] * c[1] + c[2] * c[2]).clamp(min=1e-6)
        scale = torch.where(mag > 1, (2 - 1 / mag) / mag, 1.0)
        u = [v * scale / 4 + 0.5 for v in c]
    selector = (u[0] > 0.0) & (u[0] < 1.0) & (u[1] > 0.0) & (u[1] < 1.0) & (u[2] > 0.0) & (u[2] < 1.0)
    return tuple(u), selector


def _unit_box(x: Tensor, aabb: Tensor, unbounded: bool) -> Tuple[Tensor, Tensor]:
    """Positions mapped to the encoder's ``[0, 1]^3`` (through the scene
    contraction when ``unbounded``) and the mask of those strictly
    inside."""
    if isinstance(x, (tuple, list)):
        return _unit_box_soa(x, aabb, unbounded)
    if unbounded:
        u = contract_to_unisphere(x, aabb)
    else:
        u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    return u, ((u > 0.0) & (u < 1.0)).all(dim=-1)


def _make_encoder(
    encoder_type: str, n_levels: int, n_features_per_level: int, log2_hashmap_size: int,
    base_resolution: int, max_resolution: int, compute_dtype: Optional[torch.dtype],
    table_grad: str, factor_pack: str, device, generator,
) -> nn.Module:
    """A field's encoder, built as the JAX package's ``setup`` builds it
    (``ngp.py:117-138``): ``log2_hashmap_size - 3`` for the corner-per-row
    encoders, ``compute_dtype`` and ``table_grad`` for fused and grouped
    only (the others take autograd's table gradient whatever ``table_grad``
    says, as the JAX package passes it to no other encoder), ``factor_pack``
    for fused only."""
    if encoder_type not in ENCODERS:
        raise ValueError(f"encoder_type {encoder_type!r} not in {tuple(ENCODERS)}")
    kw = dict(
        n_levels=n_levels,
        n_features_per_level=n_features_per_level,
        log2_hashmap_size=log2_hashmap_size - (3 if encoder_type in _CORNER_ROWS else 0),
        base_resolution=base_resolution,
        max_resolution=max_resolution,
        device=device,
        generator=generator,
    )
    if encoder_type == "fused":
        return HashGridEncoderFused(compute_dtype=compute_dtype, table_grad=table_grad, factor_pack=factor_pack, **kw)
    if factor_pack != "u10":
        raise ValueError(f"the {encoder_type} encoder takes no factor_pack")
    if table_grad not in TABLE_GRADS:
        raise ValueError(f"table_grad {table_grad!r} not in {TABLE_GRADS}")
    if encoder_type == "grouped":
        return HashGridEncoderGrouped(compute_dtype=compute_dtype, table_grad=table_grad, **kw)
    return ENCODERS[encoder_type](**kw)


class NGPRadianceField(nn.Module):
    """Hash-grid radiance field.  ``forward(positions, directions)`` returns
    ``(rgb (..., 3), density (..., 1))``."""

    def __init__(
        self,
        aabb: Sequence[float],
        use_viewdirs: bool = True,
        unbounded: bool = False,
        base_resolution: int = 16,
        max_resolution: int = 4096,
        geo_feat_dim: int = 15,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        mlp_width: int = 64,
        *,
        encoder_type: str = "fused",
        table_grad: str = "factor",
        factor_pack: str = "u10",
        compute_dtype: Optional[torch.dtype] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = None if compute_dtype == torch.float32 else compute_dtype
        self.use_viewdirs = use_viewdirs
        self.unbounded = unbounded
        self.geo_feat_dim = geo_feat_dim
        self.register_buffer(
            "aabb",
            torch.tensor(list(aabb), dtype=torch.float32, device=device),
            persistent=False,  # configuration, not a weight
        )
        self.encoder_type = encoder_type
        self.encoder = _make_encoder(
            encoder_type, n_levels, n_features_per_level, log2_hashmap_size, base_resolution,
            max_resolution, compute_dtype, table_grad, factor_pack, device, generator,
        )
        width = mlp_width
        self.mlp_base = nn.Sequential(
            _lecun_linear(self.encoder.latent_dim, width, generator),
            nn.ReLU(),
            _lecun_linear(width, 1 + geo_feat_dim, generator),
        ).to(device)
        self.mlp_head = None
        if geo_feat_dim > 0:
            dir_dim = 16 if use_viewdirs else 0
            self.mlp_head = nn.Sequential(
                _lecun_linear(dir_dim + geo_feat_dim, width, generator),
                nn.ReLU(),
                _lecun_linear(width, width, generator),
                nn.ReLU(),
                _lecun_linear(width, 3, generator),
            ).to(device)

    def paired_safe_levels(self, step_size: float, chunk: int = 4, margin: float = 2.0) -> int:
        """The coarsest levels safe for the fused encoder's chunk-paired
        gathers at a world-space marching ``step_size`` (``ngp.py:160-180``);
        0 for the other encoders."""
        if self.encoder_type != "fused":
            return 0
        aabb = self.aabb.detach().cpu().numpy()
        span = float(step_size / (aabb[3:] - aabb[:3]).min())
        return paired_safe_level_count(self.encoder.resolutions, span, chunk=chunk, margin=margin)

    def query_density(self, x, return_feat: bool = False, paired_levels: int = 0):
        """Density ``(..., 1)`` (and geometry features) at positions
        ``(..., 3)``, or an ``(xs, ys, zs)`` tuple of 1-D tensors (the fused
        and grouped encoders only, as the JAX package asserts); zero outside
        the box.  ``paired_levels`` goes to the fused encoder."""
        if isinstance(x, (tuple, list)) and self.encoder_type not in ("fused", "grouped"):
            raise ValueError("an (xs, ys, zs) input needs the fused or grouped encoder")
        u, selector = _unit_box(x, self.aabb, self.unbounded)
        if paired_levels and self.encoder_type == "fused":
            enc = self.encoder(u, paired_levels=paired_levels)
        else:
            enc = self.encoder(u)
        h = _mlp(self.mlp_base, enc, self.compute_dtype)
        density_before, feat = h[..., :1], h[..., 1:]
        density = _density(density_before, selector)
        if return_feat:
            return density, feat
        return density

    def _query_rgb(self, direction: Optional[Tensor], embedding: Tensor) -> Tensor:
        if self.use_viewdirs and direction is not None:
            if isinstance(direction, (tuple, list)):
                direction = torch.stack(list(direction), dim=-1)
            sh = spherical_harmonics_deg4(direction).to(embedding.dtype)
            h = torch.cat([sh, embedding], dim=-1)
        else:
            h = embedding
        return torch.sigmoid(_mlp(self.mlp_head, h, self.compute_dtype).to(torch.float32))

    def forward(self, positions, directions=None, paired_levels: int = 0):
        density, embedding = self.query_density(positions, return_feat=True, paired_levels=paired_levels)
        return self._query_rgb(directions, embedding), density


class NGPDensityField(nn.Module):
    """Density-only hash-grid field of a proposal level (``ngp.py:256-304``):
    ``forward(positions (..., 3))`` returns densities ``(..., 1)``, zero
    outside the box (or the contracted sphere when ``unbounded``).

    Its encoder is any of the five (``encoder_type``, fused by default),
    built as the radiance field builds it; the JAX package passes it no
    ``table_grad``.  At the default F = 2 the fused rows are 16 wide and
    only 128-wide rows have a table-gradient kernel, so autograd
    differentiates the row gather, as the JAX package's autodiff does for
    these nets (``hash_soa.py:275-280``).
    """

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        base_resolution: int = 16,
        max_resolution: int = 128,
        n_levels: int = 5,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 17,
        mlp_width: int = 64,
        *,
        encoder_type: str = "fused",
        compute_dtype: Optional[torch.dtype] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = None if compute_dtype == torch.float32 else compute_dtype
        self.unbounded = unbounded
        self.encoder_type = encoder_type
        self.register_buffer(
            "aabb",
            torch.tensor(list(aabb), dtype=torch.float32, device=device),
            persistent=False,  # configuration, not a weight
        )
        self.encoder = _make_encoder(
            encoder_type, n_levels, n_features_per_level, log2_hashmap_size, base_resolution,
            max_resolution, compute_dtype, "factor", "u10", device, generator,
        )
        self.mlp_base = nn.Sequential(
            _lecun_linear(self.encoder.latent_dim, mlp_width, generator),
            nn.ReLU(),
            _lecun_linear(mlp_width, 1, generator),
        ).to(device)

    def forward(self, positions: Tensor) -> Tensor:
        u, selector = _unit_box(positions, self.aabb, self.unbounded)
        h = _mlp(self.mlp_base, self.encoder(u), self.compute_dtype)
        return _density(h, selector)
