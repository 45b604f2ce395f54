"""TiNeuVox: a time-aware voxel radiance field for dynamic scenes.

Port of ``nerfacc_tpu/models/tineuvox.py``: ``TimeAwareVoxelGrid`` (a dense
``(R^3, C)`` feature grid read by trilinear taps on the sub-lattices of
strides 1, 2 and 4) and ``TiNeuVoxRadianceField`` (a time embedding, a
deformation MLP that warps each point to canonical space, the voxel
features, a density MLP and a view-conditioned colour head).

Each corner tap gathers grid rows
(:func:`~nerfacc_tpu_torch.models.tensorf.take_rows`, whose backward is one
``index_add_``), as the JAX package's ``jnp.take`` and its autodiff
scatter; no Pallas kernel is involved.  Parameters are named as flax names
them (``deform_net.4`` is flax's ``deform_net/layers_4``, ``voxels.grid``
its ``voxels/grid``), so
:func:`~nerfacc_tpu_torch.convert.field_from_jax` maps them one to
one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..device import resolve_device
from .encoding import spherical_harmonics_deg4
from .mlp import SinusoidalEncoder
from .ngp import _lecun_linear, trunc_exp
from .tensorf import _unit_box, clip, take_rows

Tensor = torch.Tensor


class TimeAwareVoxelGrid(nn.Module):
    """Dense feature voxels with multi-distance trilinear interpolation
    (``tineuvox.py:42-105``): ``x`` in ``[0, 1]^3`` to ``(..., len(strides)
    * features)``.  Stride ``s`` interpolates over every ``s``-th grid row;
    grid row ``j`` sits at ``j / (R - 1)`` at every stride, and the last
    partial sub-cell clamps to the last full one."""

    def __init__(
        self,
        resolution: int = 96,
        features: int = 8,
        strides: Tuple[int, ...] = (1, 2, 4),
        *,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        self.resolution, self.features, self.strides = resolution, features, tuple(strides)
        self.grid = nn.Parameter(torch.randn((resolution**3, features), generator=generator) * 1e-2)

    @property
    def latent_dim(self) -> int:
        return len(self.strides) * self.features

    def forward(self, x: Tensor) -> Tensor:
        R, C = self.resolution, self.features
        batch_shape = x.shape[:-1]
        xs, ys, zs = (x[..., i].reshape(-1) for i in range(3))
        n = xs.shape[0]
        outs = []
        for s in self.strides:
            ks = (R - 1) // s  # the last sub-lattice index with k * s <= R - 1

            def prep(c):
                # Multiplied, then divided, as the JAX package writes it:
                # one ulp of cf moves a sample to another cell.
                cf = clip(c, 0.0, 1.0) * (R - 1) / s
                c0 = torch.floor(cf).clamp(0, ks - 1)
                return c0.long(), clip(cf - c0, 0.0, 1.0)

            cx, wx = prep(xs)
            cy, wy = prep(ys)
            cz, wz = prep(zs)
            acc = torch.zeros((n, C), dtype=x.dtype, device=x.device)
            for dx in (0, 1):
                wxa = wx if dx else 1.0 - wx
                ix = (cx + dx) * s
                for dy in (0, 1):
                    wya = wy if dy else 1.0 - wy
                    iy = (cy + dy) * s
                    wxy = wxa * wya
                    for dz in (0, 1):
                        wza = wz if dz else 1.0 - wz
                        iz = (cz + dz) * s
                        rows = take_rows(self.grid, (ix * R + iy) * R + iz, "voxel_gather_backward")
                        acc = acc + rows * (wxy * wza)[:, None]
            outs.append(acc)
        return torch.cat(outs, dim=-1).reshape(batch_shape + (self.latent_dim,))


class TiNeuVoxRadianceField(nn.Module):
    """Deformation, time-aware voxels and shallow heads
    (``tineuvox.py:108-200``).  ``query_density(x, t)`` and ``forward(x, t,
    condition)`` as the T-NeRF fields take them; the density is
    ``trunc_exp(h - 1)``, zero where the warped point leaves the box."""

    def __init__(
        self,
        aabb: Sequence[float] = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
        resolution: int = 96,
        features: int = 8,
        strides: Tuple[int, ...] = (1, 2, 4),
        time_embed_dim: int = 8,
        net_width: int = 64,
        geo_feat_dim: int = 15,
        use_viewdirs: bool = True,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.use_viewdirs = use_viewdirs
        self.register_buffer("aabb", torch.tensor(list(aabb), dtype=torch.float32), persistent=False)
        self.posi_encoder = SinusoidalEncoder(3, 0, 8, True)
        self.time_encoder = SinusoidalEncoder(1, 0, 6, True)
        W, g = net_width, generator
        self.time_net = nn.Sequential(
            _lecun_linear(self.time_encoder.latent_dim, W, g), nn.ReLU(), _lecun_linear(W, time_embed_dim, g),
        )
        last = _lecun_linear(W, 3, g)
        with torch.no_grad():
            last.weight.copy_(torch.randn((3, W), generator=g) * 1e-4)
        self.deform_net = nn.Sequential(
            _lecun_linear(self.posi_encoder.latent_dim + time_embed_dim, W, g), nn.ReLU(),
            _lecun_linear(W, W, g), nn.ReLU(), last,
        )
        self.voxels = TimeAwareVoxelGrid(resolution, features, strides, generator=g)
        self.mlp_base = nn.Sequential(
            _lecun_linear(self.voxels.latent_dim + self.posi_encoder.latent_dim + time_embed_dim, W, g),
            nn.ReLU(),
            _lecun_linear(W, 1 + geo_feat_dim, g),
        )
        self.mlp_head = nn.Sequential(
            _lecun_linear((16 if use_viewdirs else 0) + geo_feat_dim, W, g), nn.ReLU(),
            _lecun_linear(W, W, g), nn.ReLU(), _lecun_linear(W, 3, g),
        )
        self.to(device)

    def _canonical(self, x: Tensor, t: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """The warped point in the box's ``[0, 1]^3``, the mask of those
        strictly inside, and the time embedding."""
        t_embed = self.time_net(self.time_encoder(t))
        dx = self.deform_net(torch.cat([self.posi_encoder(x), t_embed], dim=-1))
        u, selector = _unit_box(x + dx, self.aabb)
        return u, selector, t_embed

    def query_density(self, x: Tensor, t: Tensor, return_feat: bool = False):
        u, selector, t_embed = self._canonical(x, t)
        h = self.mlp_base(torch.cat([self.voxels(u), self.posi_encoder(u), t_embed], dim=-1))
        density = torch.where(selector[..., None], trunc_exp(h[..., :1] - 1), 0.0)
        return (density, h[..., 1:]) if return_feat else density

    def query_opacity(self, x: Tensor, t: Tensor, step_size: float) -> Tensor:
        return self.query_density(x, t) * step_size

    def forward(self, x: Tensor, t: Tensor, condition: Optional[Tensor] = None):
        density, geo = self.query_density(x, t, return_feat=True)
        h = geo
        if self.use_viewdirs and condition is not None:
            h = torch.cat([spherical_harmonics_deg4(condition), geo], dim=-1)
        return torch.sigmoid(self.mlp_head(h)), density
