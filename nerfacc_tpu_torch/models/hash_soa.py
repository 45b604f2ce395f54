"""Structure-of-arrays, corner-fused, grouped and folded hash-grid
encodings.

Port of ``nerfacc_tpu/models/hash_soa.py``: ``HashGridEncoderSoA`` (the
tcnn parametrisation with an ``(F, L * T)`` table), ``HashGridEncoderFused``
(with chunk-paired coarse levels), ``HashGridEncoderGrouped`` and
``HashGridEncoderFolded``, and ``paired_safe_level_count``.

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
- ``"pallas"``: :func:`~nerfacc_tpu_torch.ops.table_grad.hash_table_lookup_sized`,
  the gather whose backward sums the materialised ``(N, 128)`` cotangent
  with kernel K5, one sort and one launch a level, as the JAX package's
  ``table_grad="pallas"`` path does;
- ``"scatter"`` and ``"auto"``: the plain gather and combine under
  autograd, as the JAX package's autodiff differentiates them; the only
  route that gives the sample positions a gradient.

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

from typing import List, Optional, Tuple, Union

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
    hash_table_lookup_sized,
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


def _int32(v: int) -> int:
    """``v`` wrapped to int32, as the JAX package's int32 arithmetic keeps it."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def dense_level(resolution: int, table_size: int) -> bool:
    """Whether a corner-per-row level (fused, grouped, folded) indexes its
    table densely rather than by hash.

    The JAX package decides ``res**3 <= T`` in int32, where ``res**3``
    wraps once ``res >= 1291``: at ``res = 4095`` the cube wraps to
    -50319361 and the level is indexed densely.  The port reproduces that
    wrapped decision, so a table trained by the JAX package renders the same
    image here.
    """
    return _int32(resolution**3) <= table_size


def dense_vertex_level(resolution: int, table_size: int) -> bool:
    """Whether a tcnn-parity level (one row a vertex: ``hash``, ``soa``)
    indexes its table densely: the JAX package's ``(res + 1)**3 <= T``, in
    int32 (``encoding.py:97-98``, ``hash_soa.py:126-127``).  The cube wraps
    as :func:`dense_level`'s does: at 16 levels from 16 to 4096 the levels
    1351, 1955 and 4095 wrap to a negative number or 0 and index densely
    there, whatever ``T``; the port reproduces that."""
    return _int32((resolution + 1) ** 3) <= table_size


def paired_safe_level_count(resolutions, span: float, chunk: int = 4, margin: float = 2.0) -> int:
    """The number of coarsest levels whose cell size ``1 / res`` exceeds
    ``margin * chunk * span`` (``span`` the spacing of samples in the
    encoder's ``[0, 1]`` coordinates): the levels safe for the fused
    encoder's chunk-paired gathers (``hash_soa.py:49-62``)."""
    p = 0
    for r in resolutions:
        if 1.0 / r > margin * chunk * span:
            p += 1
        else:
            break
    return p


TABLE_GRADS = ("factor", "pallas", "scatter", "auto")


def _table(shape, device, generator) -> nn.Parameter:
    # flax's uniform(scale=2e-4) draws in [0, 2e-4); forward subtracts 1e-4.
    table = torch.empty(shape, dtype=torch.float32)
    table.uniform_(0.0, 2e-4, generator=generator)
    return nn.Parameter(table.to(device))


def _hash_rows(cx: Tensor, cy: Tensor, cz: Tensor, res_i: Tensor, dense: Tensor, T: int) -> Tensor:
    """Table rows of integer cells (or vertices), in ``[0, T)``: the dense
    index ``(cx * s + cy) * s + cz`` with stride ``s = res_i`` where
    ``dense``, else the spatial hash.  int64 keeps the low bits that JAX's
    int32/uint32 arithmetic keeps after wrapping; both sides only use
    ``& (T - 1)`` of these values."""
    dense_idx = (cx * res_i + cy) * res_i + cz
    h = (cx * _PRIMES[0]) ^ (cy * _PRIMES[1]) ^ (cz * _PRIMES[2])
    return torch.where(dense, dense_idx, h) & (T - 1)


def components(x) -> Tuple[Tensor, Tensor, Tensor, tuple]:
    """``(xs, ys, zs, batch_shape)`` of points given as ``(..., 3)`` or as an
    ``(xs, ys, zs)`` tuple of 1-D tensors (the JAX package's SoA input)."""
    if isinstance(x, (tuple, list)):
        xs, ys, zs = x
        return xs, ys, zs, tuple(xs.shape)
    u = x.reshape(-1, 3)
    return u[:, 0], u[:, 1], u[:, 2], tuple(x.shape[:-1])


def _level_buffers(module: nn.Module, resolutions, table_size: int, dense_rule, stride_add: int, device) -> None:
    """Per-level constants on the device (a lookup then copies nothing from
    the host, where a copy would wait for the queued work): resolutions
    ``(L, 1)`` float32, index strides int64, the dense decisions and the
    level offsets ``l * T``."""
    L = len(resolutions)
    consts = dict(
        _res_f=torch.tensor(resolutions, dtype=torch.float32)[:, None],
        _res_i=torch.tensor([r + stride_add for r in resolutions], dtype=torch.int64)[:, None],
        _dense=torch.tensor([dense_rule(r, table_size) for r in resolutions])[:, None],
        _level_offset=torch.arange(L, dtype=torch.int64)[:, None] * table_size,
    )
    for name, value in consts.items():
        module.register_buffer(name, value.to(device), persistent=False)


# The 8 corner offsets of a cell, corner c = 4 i + 2 j + k.
_CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


class TcnnHashGrid(nn.Module):
    """The tcnn parametrisation that
    :class:`~nerfacc_tpu_torch.models.encoding.HashGridEncoder` and
    :class:`HashGridEncoderSoA` share: their levels, vertex rule and
    encoding, on the table viewed as ``(L * T, F)`` rows (``feature_major``
    stores it ``(F, L * T)``).  ``forward`` maps ``(..., 3)`` points in
    ``[0, 1]`` (or an ``(xs, ys, zs)`` tuple) to ``(..., L * F)`` features,
    feature-fastest.

    Level ``l`` has ``res_l`` cells an axis and its ``(res_l + 1)^3``
    vertices index the table densely, with stride ``res_l + 1`` and ``&
    (T - 1)``, when that count is at most ``T`` in the JAX package's int32
    arithmetic (:func:`dense_vertex_level`, which wraps for the finest
    levels), else by the xor-prime hash.  The table is initialised as
    tcnn's, ``U(-1e-4, 1e-4)``, stored as ``U(0, 2e-4)`` and offset by
    ``-1e-4`` in the forward.

    The table gradient is autograd's of the gather, ``index_select``, whose
    backward is one ``index_add_`` (the scatter-add that JAX derives from
    ``take``): advanced indexing's backward would sort the indices and add
    the duplicates of one row one after another, and at 2^19 samples x 16
    levels x 8 corners the coarse dense levels are nearly all duplicates.
    """

    def __init__(
        self,
        n_levels: int,
        n_features_per_level: int,
        log2_hashmap_size: int,
        base_resolution: int,
        max_resolution: int,
        feature_major: bool,
        device: Union[str, torch.device],
        generator: Optional[torch.Generator],
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.n_levels, self.n_features_per_level = n_levels, n_features_per_level
        self.table_size = 1 << log2_hashmap_size
        self.resolutions = grid_resolutions(n_levels, base_resolution, max_resolution)
        self.feature_major = feature_major
        shape = (n_levels * self.table_size, n_features_per_level)
        self.table = _table(shape[::-1] if feature_major else shape, device, generator)
        _level_buffers(self, self.resolutions, self.table_size, dense_vertex_level, 1, device)
        self.register_buffer("_corners", torch.tensor(_CORNERS).to(device), persistent=False)

    @property
    def latent_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def forward(self, x) -> Tensor:
        xs, ys, zs, batch_shape = components(x)
        n, L, F = xs.shape[0], self.n_levels, self.n_features_per_level
        rows = self.table.t() if self.feature_major else self.table
        xf = torch.stack([xs, ys, zs], dim=-1)
        xl = xf[:, None, :] * self._res_f[None, :, :].to(xf.dtype)  # (n, L, 3)
        c0 = torch.floor(xl)
        w = xl - c0  # trilinear weights
        cc = c0.long()[:, :, None, :] + self._corners  # (n, L, 8, 3)
        idx = _hash_rows(cc[..., 0], cc[..., 1], cc[..., 2], self._res_i, self._dense, self.table_size)
        flat = (idx + self._level_offset).reshape(-1)
        feats = (rows - 1e-4).index_select(0, flat).view(n, L, 8, F)
        # Corner weight: the product over the axes of w or 1 - w.
        wc = torch.where(self._corners.bool(), w[:, :, None, :], 1.0 - w[:, :, None, :])
        cw = wc[..., 0] * wc[..., 1] * wc[..., 2]  # (n, L, 8)
        out = (feats * cw[..., None]).sum(dim=2)  # (n, L, F)
        return out.reshape(batch_shape + (L * F,))


class HashGridEncoderSoA(TcnnHashGrid):
    """The tcnn parametrisation with its table stored ``(F, L * T)``
    (``hash_soa.py:65-161``): the encoding of
    :class:`~nerfacc_tpu_torch.models.encoding.HashGridEncoder`
    (:class:`TcnnHashGrid`) on the transposed table, so that a JAX table
    of either layout loads as it is."""

    def __init__(
        self,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        max_resolution: int = 4096,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__(
            n_levels, n_features_per_level, log2_hashmap_size, base_resolution, max_resolution,
            True, device, generator,
        )


class HashGridEncoderFused(nn.Module):
    """Corner-fused hash encoding; ``forward`` maps ``(..., 3)`` points in
    ``[0, 1]`` (or an ``(xs, ys, zs)`` tuple of 1-D tensors) to
    ``(..., n_levels * n_features_per_level)`` features.

    ``forward(x, paired_levels=P)`` evaluates the ``P`` coarsest levels only
    at the first and last sample of each aligned run of ``pair_chunk``
    samples and interpolates the two feature vectors along the chord for the
    samples between (``hash_soa.py:413-451``): the caller promises each run
    is one straight in-order ray segment much shorter than those levels'
    cells (:func:`paired_safe_level_count`).  ``n % pair_chunk != 0`` or
    ``P > n_levels`` falls back to the unpaired encoding.
    """

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
        # Only 128-wide rows have a table-gradient kernel; "scatter" and
        # "auto" are autograd's gather backward, as on other widths.
        kernel_route = 8 * n_features_per_level == ROW_WIDTH and table_grad in ("factor", "pallas")
        self.table_grad = table_grad if kernel_route else None
        self.factor_pack = factor_pack
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.table_size = 1 << log2_hashmap_size
        self.resolutions = grid_resolutions(n_levels, base_resolution, max_resolution)
        rows = n_levels * self.table_size
        self.table = _table((rows, 8 * n_features_per_level), device, generator)
        _level_buffers(self, self.resolutions, self.table_size, dense_level, 0, device)

    @property
    def latent_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    def paired_safe_levels(self, span: float, chunk: int = 4, margin: float = 2.0) -> int:
        """:func:`paired_safe_level_count` of this encoder's levels."""
        return paired_safe_level_count(self.resolutions, span, chunk, margin)

    def cell_indices(self, u: Tensor, lo: int = 0, hi: Optional[int] = None):
        """Table rows ``(k, n)`` int64 and fractional cell weights
        ``(wx, wy, wz)``, each ``(k, n)``, of levels ``lo:hi`` (all by
        default) for ``n`` points ``u (n, 3)`` or an ``(xs, ys, zs)`` tuple."""
        xs, ys, zs, _ = components(u)
        sl = slice(lo, hi)
        res = self._res_f[sl].to(xs.dtype)
        xl, yl, zl = xs[None, :] * res, ys[None, :] * res, zs[None, :] * res
        c0x, c0y, c0z = torch.floor(xl), torch.floor(yl), torch.floor(zl)
        wx, wy, wz = xl - c0x, yl - c0y, zl - c0z
        idx = _hash_rows(c0x.long(), c0y.long(), c0z.long(), self._res_i[sl], self._dense[sl], self.table_size)
        return idx + self._level_offset[sl], (wx, wy, wz)

    def _encode(self, xs: Tensor, ys: Tensor, zs: Tensor, lo: int, hi: int) -> Tensor:
        """Levels ``lo:hi`` of points ``(m,)``: ``(hi - lo, m, F)`` in the
        compute dtype, through the table-gradient route."""
        rows, (wx, wy, wz) = self.cell_indices((xs, ys, zs), lo, hi)
        k, m = rows.shape
        rows, wx, wy, wz = rows.reshape(-1), wx.reshape(-1), wy.reshape(-1), wz.reshape(-1)
        if self.table_grad == "factor":
            out = hash_lookup_combine3(
                self.table, rows, wx, wy, wz, 1e-4, self.compute_dtype, self.factor_pack
            )
        elif self.table_grad == "pallas":
            g = hash_table_lookup_sized(
                self.table, rows, 1e-4, self.compute_dtype, level_span=self.table_size, n_levels=k, level_base=lo
            )
            out = combine(g, wx, wy, wz)
        else:
            out = gather_combine(self.table, rows, wx, wy, wz, 1e-4, self.compute_dtype)
        return out.reshape(k, m, -1)

    def forward(self, x, paired_levels: int = 0, pair_chunk: int = 4) -> Tensor:
        L, F = self.n_levels, self.n_features_per_level
        xs, ys, zs, batch_shape = components(x)
        n = xs.shape[0]
        P = int(paired_levels)
        if P > 0 and (n % pair_chunk != 0 or P > L):
            P = 0
        if P:
            C, nc = pair_chunk, n // pair_chunk

            def endpoints(a: Tensor) -> Tensor:  # (n,) -> (2 nc,): chunk firsts, then lasts
                a2 = a.reshape(nc, C)
                return torch.cat([a2[:, 0], a2[:, C - 1]])

            def chunk_bcast(a: Tensor) -> Tensor:  # (nc,) -> (n,)
                return a[:, None].expand(nc, C).reshape(n)

            xe, ye, ze = endpoints(xs), endpoints(ys), endpoints(zs)
            oe = self._encode(xe, ye, ze, 0, P)  # (P, 2 nc, F)
            # Each sample's projection on its chunk's chord, in [0, 1].
            dx0, dy0, dz0 = (c - chunk_bcast(e[:nc]) for c, e in ((xs, xe), (ys, ye), (zs, ze)))
            cxv, cyv, czv = (chunk_bcast(e[nc:] - e[:nc]) for e in (xe, ye, ze))
            den = cxv * cxv + cyv * cyv + czv * czv
            u = (dx0 * cxv + dy0 * cyv + dz0 * czv) / den.clamp(min=1e-12)
            # jnp.clip's gradient: half where u sits on a bound (a chunk's
            # first sample), as torch.maximum and torch.minimum split it.
            u = torch.minimum(torch.maximum(u, u.new_zeros(())), u.new_ones(()))
            if self.compute_dtype is not None:
                u = u.to(self.compute_dtype)
            ff = oe[:, :nc, None, :].expand(P, nc, C, F).reshape(P, n, F)
            fl = oe[:, nc:, None, :].expand(P, nc, C, F).reshape(P, n, F)
            out_p = ff + (fl - ff) * u[None, :, None]
            out = torch.cat([out_p, self._encode(xs, ys, zs, P, L)])
        else:
            out = self._encode(xs, ys, zs, 0, L)
        out = out.transpose(0, 1)  # (n, L, F)
        return out.reshape(batch_shape + (L * F,))


class HashGridEncoderGrouped(nn.Module):
    """Grouped hash encoding for the reference's tcnn shape
    (``hash_soa.py:462-651``); ``forward`` maps ``(..., 3)`` points in
    ``[0, 1]`` (or an ``(xs, ys, zs)`` tuple) to ``(..., n_levels * n_features_per_level)`` features in
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

    Under bf16 and ``table_grad="factor"`` (the default) the table gradient
    goes through kernel K6 with zero gradient to the positions; in float32,
    or with any other ``table_grad`` (the JAX package's ``"scatter"``
    ``grad_mode``, ``hash_soa.py:641-643``), autograd differentiates the
    gather in the compute dtype and the positions get their gradient
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
        table_grad: str = "factor",
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        F = n_features_per_level
        J = ROW_WIDTH // (8 * F)
        if 8 * F * J != ROW_WIDTH or n_levels % J:
            raise ValueError(f"grouped rows need 8 * F to divide {ROW_WIDTH} and n_levels % {J} == 0")
        if table_grad not in TABLE_GRADS:
            raise ValueError(f"table_grad {table_grad!r} not in {TABLE_GRADS}")
        self.compute_dtype = check_compute_dtype("HashGridEncoderGrouped", compute_dtype)
        self.grad_mode = "factor" if table_grad == "factor" else "scatter"
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

    def forward(self, x) -> Tensor:
        xs, ys, zs, batch_shape = components(x)
        xs, ys, zs = (c.to(torch.float32).contiguous() for c in (xs, ys, zs))
        n, nf = xs.shape[0], len(self.fetches)
        out = hash_lookup_combine_pos(
            self.table, self.fetch_rows(xs, ys, zs).reshape(-1), xs, ys, zs, self.fetches,
            self.n_features_per_level, 1e-4, self.compute_dtype,
            consts=FetchConsts(self._fetch_res, self._fetch_is_key, self._fetch_win), grad_mode=self.grad_mode,
        )  # (nf * n, jg * F), fetch-major
        out = out.view(nf, n, -1).transpose(0, 1)  # level-major features
        return out.reshape(batch_shape + (self.latent_dim,))


class HashGridEncoderFolded(nn.Module):
    """Corner-fused encoding whose trilinear combine is left to the first
    MLP layer (``hash_soa.py:654-762``): the table is the fused encoder's
    ``(L * T, 8 F)``, and ``forward`` returns each level's gathered row times
    its corner-weight mask, ``(..., L * 8 * F)``, lane ``c * F + f`` of a
    level's block with corner ``c = dx << 2 | dy << 1 | dz``.  Summing a
    level's 8 corner blocks gives the fused encoder's features.  The table
    gradient is autograd's: ``index_select``'s backward, an ``index_add_``."""

    def __init__(
        self,
        n_levels: int = 8,
        n_features_per_level: int = 16,
        log2_hashmap_size: int = 15,
        base_resolution: int = 16,
        max_resolution: int = 4096,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.n_levels, self.n_features_per_level = n_levels, n_features_per_level
        self.table_size = 1 << log2_hashmap_size
        self.resolutions = grid_resolutions(n_levels, base_resolution, max_resolution)
        self.table = _table((n_levels * self.table_size, 8 * n_features_per_level), device, generator)
        _level_buffers(self, self.resolutions, self.table_size, dense_level, 0, device)
        lane_c = torch.arange(8 * n_features_per_level) // n_features_per_level
        bits = torch.stack([(lane_c >> 2) & 1, (lane_c >> 1) & 1, lane_c & 1]).bool()  # (3, 8F)
        self.register_buffer("_lane_bits", bits.to(device), persistent=False)

    @property
    def latent_dim(self) -> int:
        return self.n_levels * 8 * self.n_features_per_level

    def forward(self, x: Tensor) -> Tensor:
        xs, ys, zs, batch_shape = components(x)
        n, L, F = xs.shape[0], self.n_levels, self.n_features_per_level
        res = self._res_f[:, 0].to(xs.dtype)
        lattice = [c[:, None] * res for c in (xs, ys, zs)]  # (n, L) each, sample-major
        c0 = [torch.floor(v) for v in lattice]
        w = [v - c for v, c in zip(lattice, c0)]
        idx = _hash_rows(*(c.long() for c in c0), self._res_i[:, 0], self._dense[:, 0], self.table_size)
        idx = (idx + self._level_offset[:, 0]).reshape(-1)  # (n L,)
        g = (self.table - 1e-4).index_select(0, idx).view(n, L, 8 * F)
        mask = (
            torch.where(self._lane_bits[0], w[0][..., None], 1.0 - w[0][..., None])
            * torch.where(self._lane_bits[1], w[1][..., None], 1.0 - w[1][..., None])
            * torch.where(self._lane_bits[2], w[2][..., None], 1.0 - w[2][..., None])
        )  # (n, L, 8F)
        return (g * mask).reshape(batch_shape + (L * 8 * F,))
