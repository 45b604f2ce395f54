"""Instant-NGP radiance field: fused hash grid plus two small MLPs.

Port of ``nerfacc_tpu/models/ngp.py:39-254`` for the fused encoder.
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
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .encoding import spherical_harmonics_deg4
from .hash_soa import HashGridEncoderFused

Tensor = torch.Tensor


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


def contract_to_unisphere(x: Tensor, aabb: Tensor, eps: float = 1e-6) -> Tensor:
    """MipNeRF-360 scene contraction of ``(..., 3)`` points to ``[0, 1]^3``."""
    x = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    x = x * 2 - 1  # aabb at [-1, 1]
    mag = torch.linalg.vector_norm(x, ord=2, dim=-1, keepdim=True).clamp(min=eps)
    contracted = (2 - 1 / mag) * (x / mag)
    x = torch.where(mag > 1, contracted, x)
    return x / 4 + 0.5


def _lecun_linear(
    fan_in: int, fan_out: int, generator: Optional[torch.Generator]
) -> nn.Linear:
    layer = nn.Linear(fan_in, fan_out, device="cpu")
    # flax variance_scaling(1, "fan_in", "truncated_normal"): the std of a
    # unit normal truncated to [-2, 2] is 0.87962566103423978.
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(
            layer.weight, std=std, a=-2 * std, b=2 * std, generator=generator
        )
        layer.bias.zero_()
    return layer


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
        # Each fused row stores 8 corners, so the per-level row count drops
        # 8x and the parameter budget matches the reference layout.
        self.encoder = HashGridEncoderFused(
            n_levels=n_levels,
            n_features_per_level=n_features_per_level,
            log2_hashmap_size=log2_hashmap_size - 3,
            base_resolution=base_resolution,
            max_resolution=max_resolution,
            compute_dtype=compute_dtype,
            device=device,
            generator=generator,
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

    def query_density(self, x: Tensor, return_feat: bool = False):
        """Density ``(..., 1)`` (and geometry features) at positions
        ``(..., 3)``; zero outside the box."""
        aabb = self.aabb
        if self.unbounded:
            u = contract_to_unisphere(x, aabb)
        else:
            u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
        selector = ((u > 0.0) & (u < 1.0)).all(dim=-1)
        h = self._mlp(self.mlp_base, self.encoder(u))
        density_before, feat = h[..., :1], h[..., 1:]
        density = trunc_exp(density_before.to(torch.float32) - 1) * selector[..., None]
        if return_feat:
            return density, feat
        return density

    def _mlp(self, seq: nn.Sequential, h: Tensor) -> Tensor:
        """``seq(h)``, with each layer in the compute dtype if one is set."""
        cdt = self.compute_dtype
        if cdt is None:
            return seq(h)
        h = h.to(cdt)
        for layer in seq:
            if isinstance(layer, nn.Linear):
                h = F.linear(h, layer.weight.to(cdt), layer.bias.to(cdt))
            else:
                h = layer(h)
        return h

    def _query_rgb(self, direction: Optional[Tensor], embedding: Tensor) -> Tensor:
        if self.use_viewdirs and direction is not None:
            sh = spherical_harmonics_deg4(direction).to(embedding.dtype)
            h = torch.cat([sh, embedding], dim=-1)
        else:
            h = embedding
        return torch.sigmoid(self._mlp(self.mlp_head, h).to(torch.float32))

    def forward(self, positions: Tensor, directions: Optional[Tensor] = None):
        density, embedding = self.query_density(positions, return_feat=True)
        return self._query_rgb(directions, embedding), density
