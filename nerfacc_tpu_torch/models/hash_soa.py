"""Corner-fused hash-grid encoding.

Port of ``nerfacc_tpu/models/hash_soa.py:35-48,164-459``
(``HashGridEncoderFused`` with ``paired_levels=0``).  A table row is keyed by
the *cell* and holds all 8 corner features contiguously, ``8 * F`` wide, so
a sample-level lookup is one row gather plus a trilinear combine.  The table
is one ``(L * T, 8 * F)`` parameter, laid out as the JAX package's, so JAX
tables load row for row.

With 128-wide rows (``F = 16``) the lookup is
:func:`~nerfacc_tpu_torch.ops.table_grad.hash_lookup_combine3`, whose
backward sends the table gradient through kernel K2 (bf16 compute) or K4-w3
(float32) and gives the sample positions zero gradient, as the JAX
package's ``table_grad="factor"`` path does.  Other widths have no kernel,
and autograd differentiates the gather.  ``compute_dtype=torch.bfloat16`` casts
the offset table and the corner weights to bf16 for the combine; the
weights themselves are computed in float32.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.table_grad import ROW_WIDTH, gather_combine, hash_lookup_combine3

Tensor = torch.Tensor

_PRIMES = (1, 2654435761, 805459861)


def grid_resolutions(n_levels: int, base_resolution: int, max_resolution: int) -> List[int]:
    """tcnn geometric level resolutions (computed in numpy as the JAX
    package does, so both floor to the same integers)."""
    if n_levels == 1:
        return [base_resolution]
    growth = np.exp((np.log(max_resolution) - np.log(base_resolution)) / (n_levels - 1))
    return [int(np.floor(base_resolution * growth**l)) for l in range(n_levels)]


def dense_level(resolution: int, table_size: int) -> bool:
    """Whether a level indexes its table densely rather than by hash.

    The JAX package decides ``res**3 <= T`` in int32, where ``res**3``
    wraps once ``res >= 1291``: at ``res = 4095`` the cube wraps to
    -50319361 and the level is indexed densely.  The port reproduces that
    wrapped decision, so a table trained by the JAX package renders the same
    image here.
    """
    cube = (resolution**3) & 0xFFFFFFFF
    if cube >= 1 << 31:
        cube -= 1 << 32
    return cube <= table_size


class HashGridEncoderFused(nn.Module):
    """Corner-fused hash encoding; ``forward`` maps ``(..., 3)`` points in
    ``[0, 1]`` to ``(..., n_levels * n_features_per_level)`` features."""

    def __init__(
        self,
        n_levels: int = 8,
        n_features_per_level: int = 4,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        max_resolution: int = 4096,
        *,
        compute_dtype: Optional[torch.dtype] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        if compute_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype {compute_dtype} not supported")
        self.compute_dtype = None if compute_dtype == torch.float32 else compute_dtype
        self.use_factor_grad = 8 * n_features_per_level == ROW_WIDTH
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.table_size = 1 << log2_hashmap_size
        self.resolutions = grid_resolutions(n_levels, base_resolution, max_resolution)
        rows = n_levels * self.table_size
        # flax's uniform(scale=2e-4) draws in [0, 2e-4); forward subtracts 1e-4.
        table = torch.empty((rows, 8 * n_features_per_level), dtype=torch.float32)
        table.uniform_(0.0, 2e-4, generator=generator)
        self.table = nn.Parameter(table.to(device))
        # Per-level constants on the device, so a lookup copies nothing from
        # the host (a host-to-device copy would wait for the queued work).
        level_consts = dict(
            _res_f=torch.tensor(self.resolutions, dtype=torch.float32)[:, None],
            _res_i=torch.tensor(self.resolutions, dtype=torch.int64)[:, None],
            _dense=torch.tensor([dense_level(r, self.table_size) for r in self.resolutions])[:, None],
            _level_offset=torch.arange(n_levels, dtype=torch.int64)[:, None] * self.table_size,
        )
        for name, value in level_consts.items():
            self.register_buffer(name, value.to(device), persistent=False)

    @property
    def latent_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def cell_indices(self, u: Tensor):
        """Table rows ``(L, n)`` int64 and fractional cell weights
        ``(wx, wy, wz)``, each ``(L, n)``, for ``n`` points ``u (n, 3)``."""
        T = self.table_size
        res = self._res_f.to(u.dtype)
        xl = u[None, :, 0] * res
        yl = u[None, :, 1] * res
        zl = u[None, :, 2] * res
        c0x, c0y, c0z = torch.floor(xl), torch.floor(yl), torch.floor(zl)
        wx, wy, wz = xl - c0x, yl - c0y, zl - c0z
        # int64 keeps the low bits that JAX's int32/uint32 arithmetic keeps
        # after wrapping; both sides only use `& (T - 1)` of these values.
        cx, cy, cz = c0x.long(), c0y.long(), c0z.long()
        res_i = self._res_i
        dense_idx = (cx * res_i + cy) * res_i + cz
        h = (cx * _PRIMES[0]) ^ (cy * _PRIMES[1]) ^ (cz * _PRIMES[2])
        idx = torch.where(self._dense, dense_idx, h) & (T - 1)
        return idx + self._level_offset, (wx, wy, wz)

    def forward(self, x: Tensor) -> Tensor:
        L, F = self.n_levels, self.n_features_per_level
        batch_shape = x.shape[:-1]
        u = x.reshape(-1, 3)
        n = u.shape[0]
        rows, (wx, wy, wz) = self.cell_indices(u)
        rows, wx, wy, wz = rows.reshape(-1), wx.reshape(-1), wy.reshape(-1), wz.reshape(-1)
        lookup = hash_lookup_combine3 if self.use_factor_grad else gather_combine
        out = lookup(self.table, rows, wx, wy, wz, 1e-4, self.compute_dtype)
        out = out.reshape(L, n, F).transpose(0, 1)  # (n, L, F)
        return out.reshape(batch_shape + (L * F,))
