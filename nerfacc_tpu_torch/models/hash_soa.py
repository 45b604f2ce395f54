"""Corner-fused and grouped hash-grid encodings.

Port of ``nerfacc_tpu/models/hash_soa.py:35-48,164-651``:
``HashGridEncoderFused`` (with ``paired_levels=0``) and
``HashGridEncoderGrouped``.

In the fused encoder a table row is keyed by the *cell* and holds all 8
corner features contiguously, ``8 * F`` wide, so a sample-level lookup is
one row gather plus a trilinear combine.  The table is one ``(L * T, 8 * F)``
parameter, laid out as the JAX package's, so JAX tables load row for row.
With 128-wide rows (``F = 16``) the table gradient goes through a kernel,
chosen by ``table_grad``:

- ``"factor"`` (default): :func:`~nerfacc_tpu_torch.ops.table_grad.hash_lookup_combine3`,
  whose backward sends the rank-1 factors to kernel K2 or K4 as
  ``factor_pack`` says (``"u10"``: K2 under bf16, K4-w3 under float32;
  ``"w3"``: K4-w3; ``"w8"``: K4-w8), with zero gradient to the sample
  positions, as the JAX package's ``table_grad="factor"`` path does;
- ``"pallas"``: :func:`~nerfacc_tpu_torch.ops.table_grad.hash_table_lookup`,
  the gather whose backward sums the materialised ``(N, 128)`` cotangent
  with kernel K5, as the JAX package's ``table_grad="pallas"`` path does.

Other widths have no kernel, and autograd differentiates the gather.
``compute_dtype=torch.bfloat16`` casts the offset table and the corner
weights to bf16 for the combine; the weights themselves are computed in
float32.

The grouped encoder is the reference's tcnn shape (16 levels x 2 features):
a 128-wide row holds ``J = 128 / (8 F)`` sub-levels x 8 corners x ``F``
features, fetched in ``keys_per_row`` windows of ``J / keys_per_row``
sub-levels, each keyed by its own grid (see
:class:`HashGridEncoderGrouped`).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..ops.table_grad import (
    FACTOR_PACKS,
    ROW_WIDTH,
    Fetch,
    FetchConsts,
    check_compute_dtype,
    combine,
    fetch_consts,
    gather_combine,
    hash_lookup_combine3,
    hash_lookup_combine_pos,
    hash_table_lookup,
)

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


TABLE_GRADS = ("factor", "pallas")


def _table(shape, device, generator) -> nn.Parameter:
    # flax's uniform(scale=2e-4) draws in [0, 2e-4); forward subtracts 1e-4.
    table = torch.empty(shape, dtype=torch.float32)
    table.uniform_(0.0, 2e-4, generator=generator)
    return nn.Parameter(table.to(device))


def _hash_rows(cx: Tensor, cy: Tensor, cz: Tensor, res_i: Tensor, dense: Tensor, T: int) -> Tensor:
    """Table rows of integer cells, in ``[0, T)``: the dense index where
    ``dense``, else the spatial hash.  int64 keeps the low bits that JAX's
    int32/uint32 arithmetic keeps after wrapping; both sides only use
    ``& (T - 1)`` of these values."""
    dense_idx = (cx * res_i + cy) * res_i + cz
    h = (cx * _PRIMES[0]) ^ (cy * _PRIMES[1]) ^ (cz * _PRIMES[2])
    return torch.where(dense, dense_idx, h) & (T - 1)


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
        table_grad: str = "factor",
        factor_pack: str = "u10",
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = check_compute_dtype("HashGridEncoderFused", compute_dtype)
        if table_grad not in TABLE_GRADS:
            raise ValueError(f"table_grad {table_grad!r} not in {TABLE_GRADS}")
        if factor_pack not in FACTOR_PACKS:
            raise ValueError(f"factor_pack {factor_pack!r} not in {FACTOR_PACKS}")
        # Only 128-wide rows have a table-gradient kernel.
        self.table_grad = table_grad if 8 * n_features_per_level == ROW_WIDTH else None
        self.factor_pack = factor_pack
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.table_size = 1 << log2_hashmap_size
        self.resolutions = grid_resolutions(n_levels, base_resolution, max_resolution)
        rows = n_levels * self.table_size
        self.table = _table((rows, 8 * n_features_per_level), device, generator)
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
        idx = _hash_rows(c0x.long(), c0y.long(), c0z.long(), self._res_i, self._dense, T)
        return idx + self._level_offset, (wx, wy, wz)

    def forward(self, x: Tensor) -> Tensor:
        L, F = self.n_levels, self.n_features_per_level
        batch_shape = x.shape[:-1]
        u = x.reshape(-1, 3)
        n = u.shape[0]
        rows, (wx, wy, wz) = self.cell_indices(u)
        rows, wx, wy, wz = rows.reshape(-1), wx.reshape(-1), wy.reshape(-1), wz.reshape(-1)
        if self.table_grad == "factor":
            out = hash_lookup_combine3(
                self.table, rows, wx, wy, wz, 1e-4, self.compute_dtype, self.factor_pack
            )
        elif self.table_grad == "pallas":
            out = combine(hash_table_lookup(self.table, rows, 1e-4, self.compute_dtype), wx, wy, wz)
        else:
            out = gather_combine(self.table, rows, wx, wy, wz, 1e-4, self.compute_dtype)
        out = out.reshape(L, n, F).transpose(0, 1)  # (n, L, F)
        return out.reshape(batch_shape + (L * F,))


class HashGridEncoderGrouped(nn.Module):
    """Grouped hash encoding for the reference's tcnn shape
    (``hash_soa.py:462-651``); ``forward`` maps ``(..., 3)`` points in
    ``[0, 1]`` to ``(..., n_levels * n_features_per_level)`` features in
    level-major order.

    A 128-wide table row holds ``J = 128 / (8 F)`` sub-levels x 8 corners x
    ``F`` features (column ``c * J * F + j * F + f``), and the ``L`` levels
    fill ``G = L / J`` spans of ``T`` rows.  Each span's rows are fetched in
    ``keys_per_row`` windows of ``jg = J / keys_per_row`` sub-levels (when
    ``keys_per_row`` divides ``J``; else one window), each window keyed by
    its own grid: the finest level of the window whose ``(res + 1)^3`` cells
    stay within ``key_collision_cap * T``, else the window's finest level.
    So a sample makes ``G * keys_per_row`` fetches (8 at 16 levels x 2
    features), fetch-major.  Within a window the key sub-level weighs its
    corners with the true fractions, the others with the triangle wave
    ``1 - |2 (h - floor h) - 1|``, ``h = x r / 2`` (the JAX package's default
    ``tri`` weights, the only ones whose table gradient it computes right).

    Under bf16 the table gradient goes through kernel K6 with zero gradient
    to the positions; in float32 autograd differentiates the gather
    (:func:`~nerfacc_tpu_torch.ops.table_grad.hash_lookup_combine_pos`).
    The table is the JAX encoder's ``(G * T, 128)`` ``table``, row for row,
    and the dense-index decision is its wrapped int32 one
    (:func:`dense_level`).
    """

    def __init__(
        self,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 16,
        base_resolution: int = 16,
        max_resolution: int = 4096,
        *,
        keys_per_row: int = 4,
        key_collision_cap: float = 16.0,
        compute_dtype: Optional[torch.dtype] = None,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        F = n_features_per_level
        J = ROW_WIDTH // (8 * F)
        if 8 * F * J != ROW_WIDTH or n_levels % J:
            raise ValueError(f"grouped rows need 8 * F to divide {ROW_WIDTH} and n_levels % {J} == 0")
        self.compute_dtype = check_compute_dtype("HashGridEncoderGrouped", compute_dtype)
        self.n_levels, self.n_features_per_level = n_levels, F
        self.sub_levels = J
        self.table_size = T = 1 << log2_hashmap_size
        self.resolutions = grid_resolutions(n_levels, base_resolution, max_resolution)
        self.split = keys_per_row if J % keys_per_row == 0 else 1
        self.key_collision_cap = key_collision_cap
        key_levels = self.fetch_key_levels()
        jg = J // self.split
        self.fetches = tuple(
            Fetch(
                span=g // self.split,
                j_lo=(g % self.split) * jg,
                res=tuple(self.resolutions[g * jg : (g + 1) * jg]),
                key=key - g * jg,
            )
            for g, key in enumerate(key_levels)
        )
        self.table = _table(((n_levels // J) * T, ROW_WIDTH), device, generator)
        key_res = [self.resolutions[lvl] for lvl in key_levels]
        consts = fetch_consts(self.fetches, "cpu")
        fetch_buffers = dict(
            _key_res_f=torch.tensor(key_res, dtype=torch.float32)[:, None],
            _key_res_i=torch.tensor(key_res, dtype=torch.int64)[:, None],
            _dense=torch.tensor([dense_level(r, T) for r in key_res])[:, None],
            _span_offset=torch.tensor([f.span * T for f in self.fetches], dtype=torch.int64)[:, None],
            _fetch_res=consts.res,
            _fetch_is_key=consts.is_key,
            _fetch_win=consts.win,
        )
        for name, value in fetch_buffers.items():
            self.register_buffer(name, value.to(device), persistent=False)

    def fetch_key_levels(self) -> List[int]:
        """Each fetch's key level under the collision-budget rule
        (``hash_soa.py:546-564``)."""
        T, res, cap = self.table_size, self.resolutions, self.key_collision_cap
        jg = self.sub_levels // self.split
        keys = []
        for g in range(self.n_levels // jg):
            levels = range(g * jg, (g + 1) * jg)
            ok = [lvl for lvl in levels if (res[lvl] + 1) ** 3 <= cap * T]
            keys.append(max(ok) if ok else levels[-1])
        return keys

    @property
    def latent_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def fetch_rows(self, xs: Tensor, ys: Tensor, zs: Tensor) -> Tensor:
        """Absolute table rows ``(n_fetches, n)`` int64 of each fetch's key
        cell (``hash_soa.py:617-633``)."""
        res = self._key_res_f
        cells = [torch.floor(c[None, :] * res).long() for c in (xs, ys, zs)]
        return _hash_rows(*cells, self._key_res_i, self._dense, self.table_size) + self._span_offset

    def forward(self, x: Tensor) -> Tensor:
        batch_shape = x.shape[:-1]
        u = x.reshape(-1, 3).to(torch.float32)
        xs, ys, zs = (u[:, i].contiguous() for i in range(3))
        n, nf = xs.shape[0], len(self.fetches)
        out = hash_lookup_combine_pos(
            self.table, self.fetch_rows(xs, ys, zs).reshape(-1), xs, ys, zs, self.fetches,
            self.n_features_per_level, 1e-4, self.compute_dtype,
            consts=FetchConsts(self._fetch_res, self._fetch_is_key, self._fetch_win),
        )  # (nf * n, jg * F), fetch-major
        out = out.view(nf, n, -1).transpose(0, 1)  # level-major features
        return out.reshape(batch_shape + (self.latent_dim,))
