"""Hash-table gradients (kernels K2, K4, K5, K6) and per-cell max (K3).

Port of ``nerfacc_tpu/ops/table_grad.py``:

- :func:`hash_lookup_combine3` is the fused encoder's gather plus trilinear
  combine as a ``torch.autograd.Function`` (``table_grad.py:1012-1320``).
  Its backward never builds the ``(N, 128)`` cotangent: it sorts the
  samples by table row and hands the rank-1 factors (the cell weights and
  the ``F = 16`` output cotangent of each sample) to a kernel that rebuilds
  and sums them per row.  Zero gradient goes to the weights, none to the
  rows.  ``factor_pack`` picks the factors' form, as the JAX package's
  ``NERFACC_FACTOR_PACK`` does (``hash_soa.py:388-405``,
  ``table_grad.py:1140-1141``):

  - ``"u10"`` (default): K2, :func:`table_grad_u10` (bf16 compute; replaces
    ``table_grad_factors_sorted_u10``), the weights quantised to 10 bits,
    each corner weight and each product rounded to bf16, sums in float32.
    A weight's complement ``1 - q/1023`` is rounded once, as XLA computes it
    (it contracts ``1 - q * (1/1023)`` into a fused multiply-add); rounding
    twice flips about one corner weight in a thousand by a bf16 step.  In
    float32 it takes K4's ``w3`` mode.
  - ``"w3"``: K4 in ``w3`` mode, :func:`table_grad_w3` (replaces
    ``table_grad_factors_sorted(wpack="w3")``): the three fractions in the
    compute type; in bf16 the float32 corner products are rounded to bf16.
  - ``"w8"``: K4 in ``w8`` mode, :func:`table_grad_w8` (replaces
    ``table_grad_factors_sorted(wpack="w8")``): the eight corner weights,
    cast once to the compute type.
- :func:`hash_lookup_combine` is the same gather and combine with any
  ``(N, 8)`` corner weights (``table_grad.py:851-1010``): its backward sends
  the weights and cotangents to K4 in ``w8`` mode, zero gradient to the
  weights.
- :func:`hash_table_lookup_sized` is the gather of the fused encoder's
  ``table_grad="pallas"`` route (``table_grad.py:332-437``): autograd of the
  combine materialises the ``(N, 128)`` cotangent, and its backward sorts the
  rows and sums them with K5, :func:`table_grad_sorted` (replaces
  ``table_grad_sorted``).
- :func:`hash_lookup_combine_pos` is the grouped encoder's gather plus
  multi-sub-level combine (``table_grad.py:1605-1837``).  Under bf16 and
  ``grad_mode="factor"`` its backward sorts (row, fetch) pairs and calls K6,
  :func:`table_grad_pos` (replaces ``table_grad_factors_sorted_pos``), which
  rebuilds every weight from the sample positions.
- K3, :func:`cell_max` (replaces ``cell_max_sorted``): the exact
  ``full(-1).at[ids].max(vals)`` for non-negative ``vals``.

The lookups with a factor or K5 backward take the JAX package's level split
(``level_span``, ``n_levels``, ``level_base``): the indices are promised
level-major, ``n_levels`` equal slices, slice ``j`` in rows ``[(level_base +
j) level_span, (level_base + j + 1) level_span)``; the backward then sorts
each slice on its own and launches the kernel once a slice on
``level_span`` rows, and the rows outside the slices' span get zero
gradient.  When ``N % n_levels != 0`` the whole table is sorted at once.

On a CUDA tensor each wrapper launches its hand-written kernel (K2
``csrc/table_grad_u10.cu``, K4 ``csrc/table_grad.cu``, K5
``csrc/table_grad_sorted.cu``, K6 ``csrc/table_grad_pos.cu``, K3
``csrc/cell_max.cu``) or raises; on a CPU tensor it runs the plain PyTorch
version beside it, which does the kernel's arithmetic term for term.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from . import _build

Tensor = torch.Tensor

F_PER_ROW = 16  # features per corner: 8 corners x 16 = a 128-wide table row
ROW_WIDTH = 8 * F_PER_ROW
_INV_1023 = float(np.float32(1.0 / 1023.0))  # the JAX kernel's dequantisation step
FACTOR_PACKS = ("u10", "w3", "w8")
GRAD_MODES = ("factor", "scatter")  # the grouped lookup's backward: K6, or autograd's


def corner_weights(wx: Tensor, wy: Tensor, wz: Tensor) -> Tensor:
    """``(..., 8)`` trilinear corner weights, corner ``c = 4 dx + 2 dy + dz``,
    each the float32 product ``(wx' * wy') * wz'``."""
    return torch.stack(
        [
            (wx if dx else 1.0 - wx) * (wy if dy else 1.0 - wy) * (wz if dz else 1.0 - wz)
            for dx in (0, 1)
            for dy in (0, 1)
            for dz in (0, 1)
        ],
        dim=-1,
    )


def quantize_u10(wx: Tensor, wy: Tensor, wz: Tensor) -> Tensor:
    """Three weights in ``[0, 1]`` as 10-bit fixed point in one int32,
    ``qx << 20 | qy << 10 | qz`` with ``q = clip(round_half_even(w * 1023),
    0, 1023)`` (``table_grad.py:1153-1158``)."""

    def q10(w: Tensor) -> Tensor:
        return torch.round(w * 1023.0).clamp(0.0, 1023.0).to(torch.int32)

    return (q10(wx) << 20) | (q10(wy) << 10) | q10(wz)


def u10_corner_weights(wq: Tensor) -> Tensor:
    """``(..., 8)`` float32 corner weights from :func:`quantize_u10`'s
    int32: ``w = q * (1/1023)`` and ``1 - w`` rounded once (exact in
    float64, then one rounding), multiplied as :func:`corner_weights`."""
    qs = [(wq >> s) & 1023 for s in (20, 10, 0)]
    hi = [q.to(torch.float32) * _INV_1023 for q in qs]
    lo = [(1.0 - q.to(torch.float64) * _INV_1023).to(torch.float32) for q in qs]
    return torch.stack(
        [
            (hi[0] if dx else lo[0]) * (hi[1] if dy else lo[1]) * (hi[2] if dz else lo[2])
            for dx in (0, 1)
            for dy in (0, 1)
            for dz in (0, 1)
        ],
        dim=-1,
    )


# ---------------------------------------------------------------------------
# Launching the sorted-row kernels
# ---------------------------------------------------------------------------

# Samples per warp: each warp of K5, the last user of the warp-span walk of
# csrc/sorted_rows.cuh, reduces one contiguous span of sorted samples.
_SPAN = 128
# Samples per block of K2 (``kTile`` in csrc/table_grad_u10.cu) and of K4 by
# input type (``kTileBf16``, ``kTileF32`` in csrc/table_grad.cu); each kernel
# refuses any other value.  K6 sizes its own tiles by the fetch's window.
K2_TILE = 256
K4_TILE = {torch.bfloat16: 256, torch.float32: 128}
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _lib(name: str, signatures: Tuple[Tuple[str, tuple], ...]):
    lib = _build.load(name)
    for fn_name, argtypes in signatures:
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def _table_grad_u10_lib():
    return _lib("table_grad_u10", (
        ("table_grad_u10_launch", (_P,) * 5 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_float, _P)),
    ))


def _table_grad_lib():
    tail = (ctypes.c_longlong, ctypes.c_int)
    return _lib("table_grad", (
        ("table_grad_w3_launch", (_P,) * 7 + tail + (ctypes.c_int, _P)),
        ("table_grad_w8_launch", (_P,) * 5 + tail + (ctypes.c_int, _P)),
    ))


def _launch(lib, fn_name: str, tensors, n_rows: int, *extra, span: Optional[int] = _SPAN) -> Tensor:
    """Call ``fn_name(*pointers, out, n, span, *extra, stream)`` on a zeroed
    ``(n_rows, 128)`` float32 output (no ``span`` argument where it is
    None); ``tensors[0]`` is the sorted key."""
    device = tensors[0].device
    out = torch.zeros((n_rows, ROW_WIDTH), dtype=torch.float32, device=device)
    spans = () if span is None else (span,)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(
            *[t.data_ptr() for t in tensors], out.data_ptr(), tensors[0].shape[0], *spans,
            *extra, stream,
        )
    _build.check(lib, rc, fn_name)
    return out


def _check_sorted(name: str, sorted_idx: Tensor, perm: Tensor, n_rows: int) -> None:
    n = sorted_idx.shape[0]
    if sorted_idx.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {sorted_idx.device}")
    if sorted_idx.dtype != torch.int32 or sorted_idx.ndim != 1 or not sorted_idx.is_contiguous():
        raise ValueError(f"{name}: sorted_idx must be contiguous 1-D int32")
    if perm.dtype != torch.int64 or perm.shape != (n,) or not perm.is_contiguous():
        raise ValueError(f"{name}: perm must be contiguous int64 of sorted_idx's length")
    if perm.device != sorted_idx.device:
        raise ValueError(f"{name}: all tensors must be on one device")
    if n_rows <= 0 or n_rows >= 1 << 31:
        raise ValueError(f"{name}: n_rows={n_rows} out of range")


def _check_operand(name: str, what: str, t: Tensor, dtypes, shape, device) -> None:
    if t.dtype not in dtypes or tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        want = "/".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name}: {what} must be contiguous {tuple(shape)} {want} on {device}")


def _check_aligned(name: str, **tensors: Tensor) -> None:
    for what, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be 16-byte aligned (the kernel reads it 16 bytes at a time)")


def _level_split(
    idx: Tensor, n_rows: int, level_span: int, n_levels: int, level_base: int, reduce
) -> Tensor:
    """The ``(n_rows, 128)`` float32 table gradient of a lookup at rows
    ``idx``, from ``reduce(part, sorted_idx, perm, rows)``, which sums the
    samples ``idx[part]`` into a ``(rows, 128)`` block given their rows
    sorted ascending (int32, less the block's first row) and the
    permutation that sorted them.  ``level_span == 0``: one part, the whole
    table; else one part a level (the module docstring's split), the blocks
    stacked between zero rows (``table_grad.py:388-407``)."""
    if not level_span:
        sorted_idx, perm = torch.sort(idx.to(torch.int32))
        return reduce(slice(None), sorted_idx, perm, n_rows)
    m = idx.shape[0] // n_levels
    blocks = []
    for j in range(n_levels):
        part = slice(j * m, (j + 1) * m)
        sorted_idx, perm = torch.sort((idx[part] - (level_base + j) * level_span).to(torch.int32))
        blocks.append(reduce(part, sorted_idx, perm, level_span))
    lo, hi = level_base * level_span, (level_base + n_levels) * level_span
    return torch.cat([blocks[0].new_zeros((lo, ROW_WIDTH)), *blocks, blocks[0].new_zeros((n_rows - hi, ROW_WIDTH))])


def _check_level_split(name: str, n_rows: int, n: int, level_span: int, n_levels: int, level_base: int) -> tuple:
    """The level split as the lookups take it: ``(0, 1, 0)`` (the whole
    table) when ``level_span`` is 0 or ``n`` samples do not split into
    ``n_levels`` equal slices, as the JAX package falls back; raises when the
    slices' rows do not fit in the table."""
    if not level_span or n % n_levels:
        return 0, 1, 0
    if level_span < 0 or n_levels < 1 or level_base < 0 or (level_base + n_levels) * level_span > n_rows:
        raise ValueError(f"{name}: levels {level_base} to {level_base + n_levels} of {level_span} rows "
                         f"do not fit in a table of {n_rows} rows")
    return level_span, n_levels, level_base


# ---------------------------------------------------------------------------
# K2 and K4: per-row sums of the rank-1 cotangents
# ---------------------------------------------------------------------------


def _sum_terms(sorted_idx: Tensor, w8: Tensor, d: Tensor, n_rows: int) -> Tensor:
    """``out[r, c*16+f] = sum_{k: sorted_idx[k] = r} t(w8[k, c] * d[k, f])``
    in float32, with ``t`` a rounding to ``d``'s type (bf16 or none).
    ``w8`` is already in ``d``'s type, so the product of two bf16 values is
    exact in float32 and rounds once."""
    terms = (w8.float()[:, :, None] * d.float()[:, None, :]).to(d.dtype).float()
    out = torch.zeros((n_rows, ROW_WIDTH), dtype=torch.float32, device=d.device)
    return out.index_add_(0, sorted_idx.long(), terms.reshape(-1, ROW_WIDTH))


def table_grad_u10_plain(
    sorted_idx: Tensor, perm: Tensor, wq: Tensor, dout: Tensor, n_rows: int
) -> Tensor:
    """K2's plain version: ``out[r, c*16+f] = sum_{i: idx_i = r}
    bf16(bf16(w_c(i)) * dout_i[f])`` in float32.  Sample ``sorted_idx[k]`` is sample ``perm[k]`` of
    ``wq (N,)`` and ``dout (N, 16)`` bf16, ``w_c`` from
    :func:`u10_corner_weights`."""
    p = perm.long()
    return _sum_terms(sorted_idx, u10_corner_weights(wq[p]).to(torch.bfloat16), dout[p], n_rows)


def table_grad_w3_plain(
    sorted_idx: Tensor, perm: Tensor, wx: Tensor, wy: Tensor, wz: Tensor,
    dout: Tensor, n_rows: int,
) -> Tensor:
    """K4-w3's plain version: :func:`table_grad_u10_plain`'s sum with the
    corner weights rebuilt in float32 from ``wx, wy, wz`` and cast to
    ``dout``'s type: float32 weights, products and sums for a float32
    ``dout``; bf16 corner weights and products for bf16 (the fractions then
    come in bf16)."""
    p = perm.long()
    w8 = corner_weights(wx[p].float(), wy[p].float(), wz[p].float())
    return _sum_terms(sorted_idx, w8.to(dout.dtype), dout[p], n_rows)


def table_grad_w8_plain(
    sorted_idx: Tensor, perm: Tensor, w8: Tensor, dout: Tensor, n_rows: int
) -> Tensor:
    """K4-w8's plain version: the sum of :func:`table_grad_u10_plain` with
    the corner weights given, ``w8 (N, 8)`` in ``dout``'s type (bf16 terms
    rounded to bf16, float32 terms not)."""
    p = perm.long()
    return _sum_terms(sorted_idx, w8[p], dout[p], n_rows)


def table_grad_u10(
    sorted_idx: Tensor, perm: Tensor, wq: Tensor, dout: Tensor, n_rows: int
) -> Tensor:
    """Kernel K2: the ``(n_rows, 128)`` float32 table gradient from rows
    sorted ascending (``sorted_idx`` int32, in ``[0, n_rows)``), the
    permutation that sorted them (``perm`` int64), u10 weights ``wq`` int32
    and ``dout (N, 16)`` bf16, both in unsorted sample order.  A block
    stages :data:`K2_TILE` sorted samples' corner weights and cotangents,
    and each warp walks its share of them.  A CPU tensor takes
    :func:`table_grad_u10_plain`; a CUDA tensor launches the kernel (one
    launch for all levels) or raises."""
    if dout.device.type == "cpu":
        return table_grad_u10_plain(sorted_idx, perm, wq, dout, n_rows)
    name = "table_grad_u10"
    _check_sorted(name, sorted_idx, perm, n_rows)
    n, dev = perm.shape[0], sorted_idx.device
    _check_operand(name, "dout", dout, (torch.bfloat16,), (n, F_PER_ROW), dev)
    _check_operand(name, "wq", wq, (torch.int32,), (n,), dev)
    _check_aligned(name, sorted_idx=sorted_idx, perm=perm, dout=dout)
    out = _launch(
        _table_grad_u10_lib(), "table_grad_u10_launch", (sorted_idx, perm, wq, dout), n_rows, _INV_1023,
        span=K2_TILE,
    )
    table_grad_u10.launches += 1
    return out


table_grad_u10.launches = 0  # kernel launches since the count was last reset


def table_grad_w3(
    sorted_idx: Tensor, perm: Tensor, wx: Tensor, wy: Tensor, wz: Tensor,
    dout: Tensor, n_rows: int,
) -> Tensor:
    """Kernel K4 in ``w3`` mode: :func:`table_grad_u10`'s sum from the
    fractions ``wx, wy, wz`` and ``dout (N, 16)``, all float32 or all bf16.
    A block stages :data:`K4_TILE` sorted samples of that type, as K2's
    does.  A CPU tensor takes :func:`table_grad_w3_plain`; a CUDA tensor
    launches the kernel (``sorted_idx``, ``perm`` and ``dout`` 16-byte
    aligned) or raises."""
    if dout.device.type == "cpu":
        return table_grad_w3_plain(sorted_idx, perm, wx, wy, wz, dout, n_rows)
    name = "table_grad_w3"
    _check_sorted(name, sorted_idx, perm, n_rows)
    n, dev = perm.shape[0], sorted_idx.device
    _check_operand(name, "dout", dout, (torch.float32, torch.bfloat16), (n, F_PER_ROW), dev)
    for what, w in (("wx", wx), ("wy", wy), ("wz", wz)):
        _check_operand(name, what, w, (dout.dtype,), (n,), dev)
    _check_aligned(name, sorted_idx=sorted_idx, perm=perm, dout=dout)
    out = _launch(
        _table_grad_lib(), "table_grad_w3_launch", (sorted_idx, perm, wx, wy, wz, dout), n_rows,
        int(dout.dtype == torch.bfloat16), span=K4_TILE[dout.dtype],
    )
    table_grad_w3.launches += 1
    return out


table_grad_w3.launches = 0  # kernel launches since the count was last reset


def table_grad_w8(
    sorted_idx: Tensor, perm: Tensor, w8: Tensor, dout: Tensor, n_rows: int
) -> Tensor:
    """Kernel K4 in ``w8`` mode: :func:`table_grad_u10`'s sum from the
    corner weights ``w8 (N, 8)`` and ``dout (N, 16)``, both float32 or both
    bf16.  A CPU tensor takes :func:`table_grad_w8_plain`; a CUDA tensor
    launches the kernel (``sorted_idx``, ``perm``, ``w8`` and ``dout``
    16-byte aligned) or raises."""
    if dout.device.type == "cpu":
        return table_grad_w8_plain(sorted_idx, perm, w8, dout, n_rows)
    name = "table_grad_w8"
    _check_sorted(name, sorted_idx, perm, n_rows)
    n, dev = perm.shape[0], sorted_idx.device
    _check_operand(name, "dout", dout, (torch.float32, torch.bfloat16), (n, F_PER_ROW), dev)
    _check_operand(name, "w8", w8, (dout.dtype,), (n, 8), dev)
    _check_aligned(name, sorted_idx=sorted_idx, perm=perm, w8=w8, dout=dout)
    out = _launch(
        _table_grad_lib(), "table_grad_w8_launch", (sorted_idx, perm, w8, dout), n_rows,
        int(dout.dtype == torch.bfloat16), span=K4_TILE[dout.dtype],
    )
    table_grad_w8.launches += 1
    return out


table_grad_w8.launches = 0  # kernel launches since the count was last reset


def table_grad_factors(
    idx: Tensor, wx: Tensor, wy: Tensor, wz: Tensor, dout: Tensor, n_rows: int,
    factor_pack: str = "u10", level_span: int = 0, n_levels: int = 1, level_base: int = 0,
) -> Tensor:
    """The table gradient of :func:`hash_lookup_combine3`: sort the rows
    (``torch.sort``, outside the kernel, as the JAX package sorts outside
    its Pallas kernel), then K2 (``"u10"`` under bf16), K4-w3 (``"u10"``
    under float32, ``"w3"``) or K4-w8 (``"w8"``), in ``dout``'s type; once,
    or once a level under a level split (:func:`_level_split`)."""
    if dout.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"table_grad_factors: dout must be bf16 or float32, got {dout.dtype}")
    if factor_pack not in FACTOR_PACKS:
        raise ValueError(f"table_grad_factors: factor_pack {factor_pack!r} not in {FACTOR_PACKS}")

    def reduce(part, sorted_idx, perm, rows):
        ws, d = (wx[part], wy[part], wz[part]), dout[part].contiguous()
        if factor_pack == "u10" and d.dtype == torch.bfloat16:
            return table_grad_u10(sorted_idx, perm, quantize_u10(*ws), d, rows)
        if factor_pack == "w8":
            return table_grad_w8(sorted_idx, perm, corner_weights(*ws).to(d.dtype).contiguous(), d, rows)
        return table_grad_w3(sorted_idx, perm, *[w.to(d.dtype).contiguous() for w in ws], d, rows)

    return _level_split(idx, n_rows, level_span, n_levels, level_base, reduce)


def combine8(g: Tensor, w8: Tensor) -> Tensor:
    """Gathered rows ``g (N, 8 F)`` combined over their 8 corners with the
    corner weights ``w8 (N, 8)`` cast to ``g``'s type: ``(N, F)``."""
    return torch.einsum("kc,kcf->kf", w8.to(g.dtype), g.view(-1, 8, g.shape[1] // 8))


def combine(g: Tensor, wx: Tensor, wy: Tensor, wz: Tensor) -> Tensor:
    """:func:`combine8` with the trilinear weights of ``(wx, wy, wz)``
    (float32)."""
    return combine8(g, corner_weights(wx, wy, wz))


def _offset_table(table: Tensor, offset: float, compute_dtype: Optional[torch.dtype]) -> Tensor:
    t = table - offset
    return t if compute_dtype is None else t.to(compute_dtype)


def gather_combine(
    table: Tensor, idx: Tensor, wx: Tensor, wy: Tensor, wz: Tensor,
    offset: float, compute_dtype: Optional[torch.dtype],
) -> Tensor:
    """Rows ``idx`` of ``table - offset`` (cast to ``compute_dtype`` if
    given), combined by :func:`combine`: ``(N, F)``.  Autograd
    differentiates it as written; :func:`hash_lookup_combine3` gives it the
    factor backward."""
    with record_function("gather_combine"):
        return combine(_offset_table(table, offset, compute_dtype)[idx], wx, wy, wz)


class _LookupCombine3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, wx, wy, wz, offset, compute_dtype, factor_pack, split):
        out = gather_combine(table, idx, wx, wy, wz, offset, compute_dtype)
        ctx.save_for_backward(idx, wx, wy, wz)
        ctx.n_rows, ctx.factor_pack, ctx.split = table.shape[0], factor_pack, split
        return out

    @staticmethod
    def backward(ctx, dout):
        idx, wx, wy, wz = ctx.saved_tensors
        with record_function("table_grad"):
            dtable = table_grad_factors(idx, wx, wy, wz, dout, ctx.n_rows, ctx.factor_pack, *ctx.split)
        zero = [torch.zeros_like(w) if need else None for w, need in zip((wx, wy, wz), ctx.needs_input_grad[2:5])]
        return (dtable, None, *zero, None, None, None, None)


def check_compute_dtype(name: str, compute_dtype) -> Optional[torch.dtype]:
    """``compute_dtype`` as the lookups take it: ``None`` (float32) or
    bf16; raises on anything else."""
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: compute_dtype {compute_dtype} not supported")
    return None if compute_dtype == torch.float32 else compute_dtype


def hash_lookup_combine3(
    table: Tensor,
    idx: Tensor,
    wx: Tensor,
    wy: Tensor,
    wz: Tensor,
    offset: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
    factor_pack: str = "u10",
    level_span: int = 0,
    n_levels: int = 1,
    level_base: int = 0,
) -> Tensor:
    """Gather rows ``idx`` of ``table - offset`` (``(n_rows, 128)`` float32,
    cast to ``compute_dtype`` if given) and combine each row's 8 corners of
    16 features with the trilinear weights of ``(wx, wy, wz)``: ``(N, 16)``
    in the compute dtype.  Backward: the table gradient through K2 or K4 as
    ``factor_pack`` says (:func:`table_grad_factors`), once or once a level
    (the module docstring's level split), zero to the weights, none to
    ``idx``."""
    name = "hash_lookup_combine3"
    if table.ndim != 2 or table.shape[1] != ROW_WIDTH:
        raise ValueError(f"{name}: table must be (n_rows, {ROW_WIDTH})")
    if factor_pack not in FACTOR_PACKS:
        raise ValueError(f"{name}: factor_pack {factor_pack!r} not in {FACTOR_PACKS}")
    cdt = check_compute_dtype(name, compute_dtype)
    split = _check_level_split(name, table.shape[0], idx.shape[0], level_span, n_levels, level_base)
    return _LookupCombine3.apply(table, idx, wx, wy, wz, offset, cdt, factor_pack, split)


class _LookupCombine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, w, offset, compute_dtype, split):
        ctx.save_for_backward(idx, w)
        ctx.n_rows, ctx.split = table.shape[0], split
        with record_function("gather_combine"):
            return combine8(_offset_table(table, offset, compute_dtype)[idx], w)

    @staticmethod
    def backward(ctx, dout):
        idx, w = ctx.saved_tensors
        # The factors in the compute type (the cotangent's): bf16 or float32.
        w8, d = w.to(dout.dtype).contiguous(), dout.contiguous()
        with record_function("table_grad"):
            dtable = _level_split(
                idx, ctx.n_rows, *ctx.split,
                lambda part, sorted_idx, perm, rows: table_grad_w8(sorted_idx, perm, w8[part], d[part], rows),
            )
        return dtable, None, torch.zeros_like(w) if ctx.needs_input_grad[2] else None, None, None, None


def hash_lookup_combine(
    table: Tensor,
    idx: Tensor,
    w: Tensor,
    offset: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
    level_span: int = 0,
    n_levels: int = 1,
    level_base: int = 0,
) -> Tensor:
    """Gather rows ``idx`` of ``table - offset`` (``(n_rows, 128)`` float32,
    cast to ``compute_dtype`` if given) and combine each row's 8 corners of
    16 features with the given corner weights ``w (N, 8)`` (any weights, cast
    to the compute dtype): ``(N, 16)`` in the compute dtype
    (``table_grad.py:851-1010``).  Backward: the table gradient through
    K4-w8 (:func:`table_grad_w8`) from ``w`` and the cotangent in the
    compute type, once or once a level (the module docstring's level
    split); zero gradient to ``w`` by contract, none to ``idx``."""
    name = "hash_lookup_combine"
    if table.ndim != 2 or table.shape[1] != ROW_WIDTH:
        raise ValueError(f"{name}: table must be (n_rows, {ROW_WIDTH})")
    if w.shape != (idx.shape[0], 8):
        raise ValueError(f"{name}: w must be (N, 8) corner weights of idx's N samples")
    cdt = check_compute_dtype(name, compute_dtype)
    split = _check_level_split(name, table.shape[0], idx.shape[0], level_span, n_levels, level_base)
    return _LookupCombine.apply(table, idx, w, offset, cdt, split)


# ---------------------------------------------------------------------------
# K5: segment sum of a materialised cotangent
# ---------------------------------------------------------------------------


def _table_grad_sorted_lib():
    return _lib("table_grad_sorted", (
        ("table_grad_sorted_launch", (_P,) * 4 + (ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P)),
    ))


def table_grad_sorted_plain(sorted_idx: Tensor, perm: Tensor, dg: Tensor, n_rows: int) -> Tensor:
    """K5's plain version: ``zeros(n_rows, 128).index_add_(sorted_idx,
    dg[perm])``, the float32 per-row sums of the ``(N, 128)`` rows."""
    out = torch.zeros((n_rows, ROW_WIDTH), dtype=torch.float32, device=dg.device)
    return out.index_add_(0, sorted_idx.long(), dg[perm.long()].float())


def table_grad_sorted(sorted_idx: Tensor, perm: Tensor, dg: Tensor, n_rows: int) -> Tensor:
    """Kernel K5: the ``(n_rows, 128)`` float32 per-row sums of the
    cotangent ``dg (N, 128)`` (bf16 or float32, unsorted sample order) over
    rows sorted ascending (``sorted_idx`` int32, ``perm`` int64 the
    permutation that sorted them).  A CPU tensor takes
    :func:`table_grad_sorted_plain`; a CUDA tensor launches the kernel or
    raises."""
    if dg.device.type == "cpu":
        return table_grad_sorted_plain(sorted_idx, perm, dg, n_rows)
    name = "table_grad_sorted"
    _check_sorted(name, sorted_idx, perm, n_rows)
    _check_operand(name, "dg", dg, (torch.float32, torch.bfloat16), (perm.shape[0], ROW_WIDTH), sorted_idx.device)
    out = _launch(
        _table_grad_sorted_lib(), "table_grad_sorted_launch", (sorted_idx, perm, dg), n_rows,
        int(dg.dtype == torch.bfloat16),
    )
    table_grad_sorted.launches += 1
    return out


table_grad_sorted.launches = 0  # kernel launches since the count was last reset


class _Lookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, offset, compute_dtype, split):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.split = table.shape[0], split
        return _offset_table(table, offset, compute_dtype)[idx]

    @staticmethod
    def backward(ctx, dg):
        (idx,) = ctx.saved_tensors
        with record_function("table_grad"):
            dtable = _level_split(
                idx, ctx.n_rows, *ctx.split,
                lambda part, sorted_idx, perm, rows: table_grad_sorted(sorted_idx, perm, dg[part].contiguous(), rows),
            )
        return dtable, None, None, None, None


def hash_table_lookup_sized(
    table: Tensor,
    idx: Tensor,
    offset: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
    level_span: int = 0,
    n_levels: int = 1,
    level_base: int = 0,
) -> Tensor:
    """Rows ``idx`` of ``table - offset`` (``(n_rows, 128)`` float32, cast to
    ``compute_dtype`` if given): ``(N, 128)``.  Backward: the cotangent of
    the rows, in the compute dtype as autograd of the consumer gives it,
    sorted by row and summed in float32 by K5 (the JAX package's
    ``table_grad="pallas"`` route, ``table_grad.py:332-437``): one sort and
    one launch over the whole table, or one a level on ``level_span`` rows
    under the module docstring's level split."""
    name = "hash_table_lookup_sized"
    if table.ndim != 2 or table.shape[1] != ROW_WIDTH:
        raise ValueError(f"{name}: table must be (n_rows, {ROW_WIDTH})")
    split = _check_level_split(name, table.shape[0], idx.shape[0], level_span, n_levels, level_base)
    return _Lookup.apply(table, idx, offset, check_compute_dtype(name, compute_dtype), split)


# ---------------------------------------------------------------------------
# K6: the grouped encoder's table gradient, weights rebuilt from positions
# ---------------------------------------------------------------------------


class Fetch(NamedTuple):
    """One fetch of the grouped encoder (``hash_soa.py:606-615``): the span
    of ``T`` table rows it reads, the first sub-level ``j_lo`` of its window
    in the row, the window's sub-level resolutions, and the window index of
    its key sub-level."""

    span: int
    j_lo: int
    res: Tuple[int, ...]
    key: int


class FetchConsts(NamedTuple):
    """Per-fetch constants on the device: resolutions ``(n_fetches, jg)``
    float32, the key sub-level mask ``(n_fetches, jg)`` bool and the window
    index ``j_lo / jg`` ``(n_fetches, 1)`` int64."""

    res: Tensor
    is_key: Tensor
    win: Tensor


def fetch_consts(fetches: Sequence[Fetch], device) -> FetchConsts:
    jg = len(fetches[0].res)
    return FetchConsts(
        res=torch.tensor([f.res for f in fetches], dtype=torch.float32, device=device),
        is_key=torch.tensor([[k == f.key for k in range(jg)] for f in fetches], device=device),
        win=torch.tensor([[f.j_lo // jg] for f in fetches], dtype=torch.int64, device=device),
    )


def sub_level_weights(x: Tensor, res: Tensor, is_key: Tensor) -> Tensor:
    """Trilinear weights along one axis at sub-level resolution ``res``:
    the true fraction ``x r - floor(x r)`` where ``is_key``, else the
    triangle wave ``1 - |2 (h - floor h) - 1|`` with ``h = x r / 2``
    (``table_grad.py:1665-1690``), in float32, each step rounded (XLA on the
    CPU contracts none of them)."""
    xl = x * res
    h = xl * 0.5
    tri = 1.0 - (2.0 * (h - torch.floor(h)) - 1.0).abs()
    return torch.where(is_key, xl - torch.floor(xl), tri)


def _grouped_corner_weights(xs, ys, zs, res, is_key) -> Tensor:
    """``(..., 8, jg)`` float32 corner weights ``(wx' * wy') * wz'`` of each
    sub-level (corner ``c = 4 dx + 2 dy + dz``), from positions broadcast
    against ``res`` and ``is_key`` ``(..., jg)``.  Built by broadcast
    products in this layout: stacking eight ``(..., jg)`` products along a
    new axis is a strided copy that took more device time than the gather."""
    hi = torch.arange(2, device=res.device).bool()[:, None]  # the corner's side on an axis
    ax, ay, az = (
        torch.where(hi, w[..., None, :], 1.0 - w[..., None, :])  # (..., 2, jg)
        for w in (sub_level_weights(c, res, is_key) for c in (xs, ys, zs))
    )
    w = (ax[..., :, None, None, :] * ay[..., None, :, None, :]) * az[..., None, None, :, :]
    return w.flatten(-4, -2)


def _check_fetches(fetches: Sequence[Fetch], F: int) -> Tuple[int, int]:
    J = ROW_WIDTH // (8 * F)
    if 8 * F * J != ROW_WIDTH:
        raise ValueError(f"grouped rows need 8 * F to divide {ROW_WIDTH}, got F={F}")
    jg = len(fetches[0].res)
    if any(len(f.res) != jg or f.j_lo % jg or f.j_lo + jg > J for f in fetches):
        raise ValueError("every fetch needs the same number of sub-levels, in an aligned window of the row")
    return J, jg


def shared_windows(fetches: Sequence[Fetch]) -> list:
    """The ``(span, j_lo)`` windows that more than one of ``fetches``
    reads, sorted.  Such fetches name the same columns of the same rows:
    :func:`table_grad_pos_plain` sums their terms, while K6 stores each run
    that no other warp holds part of, so one would overwrite the other."""
    seen = [(f.span, f.j_lo) for f in fetches]
    return sorted({w for w in seen if seen.count(w) > 1})


def table_grad_pos_plain(
    sorted_key: Tensor, perm: Tensor, xs: Tensor, ys: Tensor, zs: Tensor,
    dout: Tensor, n_rows: int, fetches: Sequence[Fetch], F: int,
    consts: Optional[FetchConsts] = None,
) -> Tensor:
    """K6's plain version.  Pair ``perm[k]`` (fetch-major, fetch
    ``perm[k] // n`` of sample ``perm[k] % n``) has key ``sorted_key[k] =
    row * n_fetches + fetch``; its terms ``bf16(bf16(w_{c,j}) * dout[j*F+f])``
    go to ``out[row, c*J*F + (j_lo + j)*F + f]``, summed in float32.  The
    weights come from :func:`sub_level_weights` at the fetch's
    resolutions; ``consts`` are :func:`fetch_consts` of ``fetches`` on the
    positions' device (built here when not given)."""
    J, jg = _check_fetches(fetches, F)
    nf, n = len(fetches), xs.shape[0]
    if consts is None:
        consts = fetch_consts(fetches, xs.device)
    key = sorted_key.long()
    g, row = key % nf, key // nf
    p = perm.long()
    s = p % n
    w = _grouped_corner_weights(xs[s, None], ys[s, None], zs[s, None], consts.res[g], consts.is_key[g])
    w = w.to(torch.bfloat16).float()  # (m, 8, jg)
    d = dout[p].view(-1, 1, jg, F).float()
    terms = (w[..., None] * d).to(torch.bfloat16).float()  # (m, 8, jg, F)
    c = torch.arange(8, device=xs.device)[:, None, None] * (J * F)
    kf = torch.arange(jg * F, device=xs.device).view(1, jg, F)
    cols = c + kf + consts.win[g, :, None, None] * (jg * F)  # (m, 8, jg, F)
    flat = (row[:, None, None, None] * ROW_WIDTH + cols).reshape(-1)
    out = torch.zeros(n_rows * ROW_WIDTH, dtype=torch.float32, device=xs.device)
    return out.index_add_(0, flat, terms.reshape(-1)).view(n_rows, ROW_WIDTH)


def _table_grad_pos_lib():
    ci, cll = ctypes.c_int, ctypes.c_longlong
    return _lib("table_grad_pos", (
        ("table_grad_pos_launch", (_P,) * 8 + (cll, cll, ci, ci, ci, ci)
         + (ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ci), ctypes.POINTER(ci), _P)),
    ))


def table_grad_pos(
    sorted_key: Tensor, perm: Tensor, xs: Tensor, ys: Tensor, zs: Tensor,
    dout: Tensor, n_rows: int, fetches: Sequence[Fetch], F: int,
    consts: Optional[FetchConsts] = None,
) -> Tensor:
    """Kernel K6: the ``(n_rows, 128)`` float32 table gradient of the
    grouped encoder from its (row, fetch) keys sorted ascending
    (``sorted_key`` int32, ``row * n_fetches + fetch``), the permutation
    that sorted them (``perm`` int64, into the fetch-major pairs), the
    float32 positions ``xs, ys, zs (n,)`` and ``dout (n_fetches * n, jg *
    F)`` bf16.  One launch covers every fetch; a block stages a tile of
    pairs' weights and cotangents, and a walker of ``min(32, 8 jg F)``
    lanes walks the tile's pairs, the ``8 jg F`` active columns of a fetch
    spread over its lanes.  The kernel takes every window the grouped
    encoder builds: ``jg * F`` in 1, 2, 4, 8 and 16 (every ``keys_per_row``
    dividing ``J``, for every ``F``), and at most 32 fetches.  It stores,
    not adds, a run that no other walker holds part of, so it refuses
    fetches that share a span and a window (:func:`shared_windows`), whose
    terms the plain version would sum; the encoder's fetches never do (each
    reads its own span's rows or its own window).  A CPU tensor takes
    :func:`table_grad_pos_plain` (with ``consts``); a CUDA tensor launches
    the kernel or raises."""
    if dout.device.type == "cpu":
        return table_grad_pos_plain(sorted_key, perm, xs, ys, zs, dout, n_rows, fetches, F, consts)
    name = "table_grad_pos"
    J, jg = _check_fetches(fetches, F)
    nf, n = len(fetches), xs.shape[0]
    cols = jg * F
    if cols & (cols - 1) or nf > 32:
        raise ValueError(f"{name}: the kernel takes jg * F in (1, 2, 4, 8, 16) and at most 32 fetches, "
                         f"got jg * F = {cols} and {nf} fetches")
    shared = shared_windows(fetches)
    if shared:
        raise ValueError(f"{name}: fetches share the (span, j_lo) windows {shared}; the kernel cannot sum them")
    _check_sorted(name, sorted_key, perm, n_rows)
    if n_rows * nf >= 1 << 31:
        raise ValueError(f"{name}: row * n_fetches overflows int32")
    if nf * n >= 1 << 32:
        raise ValueError(f"{name}: the kernel indexes at most 2^32 (fetch, sample) pairs")
    dev = sorted_key.device
    for what, t in (("xs", xs), ("ys", ys), ("zs", zs)):
        _check_operand(name, what, t, (torch.float32,), (n,), dev)
    _check_operand(name, "dout", dout, (torch.bfloat16,), (nf * n, jg * F), dev)
    if dout.data_ptr() % min(16, 2 * cols):
        raise ValueError(f"{name}: dout must be {min(16, 2 * cols)}-byte aligned (its rows are read whole)")
    res = (ctypes.c_float * (nf * jg))(*[float(r) for f in fetches for r in f.res])
    j_lo = (ctypes.c_int * nf)(*[f.j_lo for f in fetches])
    key = (ctypes.c_int * nf)(*[f.key for f in fetches])
    pos = torch.empty((n, 4), dtype=torch.float32, device=dev)  # the kernel packs the positions here
    out = _launch(
        _table_grad_pos_lib(), "table_grad_pos_launch", (sorted_key, perm, xs, ys, zs, pos, dout), n_rows,
        n, nf, jg, F, J, res, j_lo, key, span=None,
    )
    table_grad_pos.launches += 1
    return out


table_grad_pos.launches = 0  # kernel launches since the count was last reset


def gather_combine_pos(
    table: Tensor, idx: Tensor, xs: Tensor, ys: Tensor, zs: Tensor,
    consts: FetchConsts, F: int, offset: float, compute_dtype: Optional[torch.dtype],
) -> Tensor:
    """The grouped lookup as autograd differentiates it: fetch ``g`` of
    sample ``i`` gathers the active ``8 x jg x F`` lanes of row
    ``idx[g*n + i]`` of ``table - offset`` (cast to ``compute_dtype``),
    multiplies each sub-level's corners by their float32 weights cast to the
    compute dtype, and sums the 8 corners in float32:
    ``(n_fetches * n, jg * F)`` in the compute dtype (``table.py:1644-1720``)."""
    nf, jg = consts.res.shape
    n = xs.shape[0]
    J = ROW_WIDTH // (8 * F)
    with record_function("gather_combine"):
        t = _offset_table(table, offset, compute_dtype)
        rows = t.view(-1, 8, J // jg, jg, F)[idx, :, consts.win.expand(nf, n).reshape(-1)]  # (nf n, 8, jg, F)
        w = _grouped_corner_weights(xs[None, :, None], ys[None, :, None], zs[None, :, None],
                                    consts.res[:, None, :], consts.is_key[:, None, :])
        prod = rows * w.reshape(nf * n, 8, jg, 1).to(rows.dtype)
        return prod.float().sum(dim=1).to(rows.dtype).reshape(nf * n, jg * F)


class _LookupCombinePos(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, xs, ys, zs, fetches, consts, F, offset, compute_dtype):
        out = gather_combine_pos(table, idx, xs, ys, zs, consts, F, offset, compute_dtype)
        ctx.save_for_backward(idx, xs, ys, zs)
        ctx.n_rows, ctx.fetches, ctx.consts, ctx.F = table.shape[0], fetches, consts, F
        return out

    @staticmethod
    def backward(ctx, dout):
        idx, xs, ys, zs = ctx.saved_tensors
        nf, n = len(ctx.fetches), xs.shape[0]
        with record_function("table_grad"):
            fetch = torch.arange(nf, dtype=torch.int64, device=idx.device)[:, None]
            key = (idx.reshape(nf, n) * nf + fetch).reshape(-1).to(torch.int32)
            sorted_key, perm = torch.sort(key)
            dtable = table_grad_pos(
                sorted_key, perm, xs.contiguous(), ys.contiguous(), zs.contiguous(),
                dout.to(torch.bfloat16).contiguous(), ctx.n_rows, ctx.fetches, ctx.F, ctx.consts,
            )
        zero = [torch.zeros_like(c) if need else None for c, need in zip((xs, ys, zs), ctx.needs_input_grad[2:5])]
        return (dtable, None, *zero, None, None, None, None, None)


def hash_lookup_combine_pos(
    table: Tensor,
    idx: Tensor,
    xs: Tensor,
    ys: Tensor,
    zs: Tensor,
    fetches: Sequence[Fetch],
    F: int = 2,
    offset: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
    consts: Optional[FetchConsts] = None,
    grad_mode: str = "factor",
) -> Tensor:
    """The grouped encoder's fused gather and multi-sub-level combine
    (``hash_lookup_combine_pos``, ``table_grad.py:1803-1837``): ``table``
    ``(n_spans * T, 128)`` float32, ``idx (n_fetches * n,)`` absolute rows,
    fetch-major, ``xs, ys, zs (n,)`` float32 positions in ``[0, 1]``.
    Returns ``(n_fetches * n, jg * F)`` in the compute dtype.

    Under bf16 and ``grad_mode="factor"`` the backward sorts the (row,
    fetch) pairs and sends the table gradient through K6, with zero gradient
    to the positions (the JAX package's factor route).  In float32, or with
    ``grad_mode="scatter"``, autograd differentiates
    :func:`gather_combine_pos` as written in the compute dtype, as the JAX
    package differentiates its plain combine (``table_grad.py:1722-1728``):
    no kernel on that route there either, and the positions get their
    gradient.  ``consts`` are :func:`fetch_consts` of ``fetches`` on the
    positions' device (built here when not given)."""
    if table.ndim != 2 or table.shape[1] != ROW_WIDTH:
        raise ValueError(f"hash_lookup_combine_pos: table must be (n_rows, {ROW_WIDTH})")
    _check_fetches(fetches, F)
    if idx.shape != (len(fetches) * xs.shape[0],):
        raise ValueError("hash_lookup_combine_pos: idx must hold n_fetches * n rows, fetch-major")
    cdt = check_compute_dtype("hash_lookup_combine_pos", compute_dtype)
    if grad_mode not in GRAD_MODES:
        raise ValueError(f"hash_lookup_combine_pos: grad_mode {grad_mode!r} not in {GRAD_MODES}")
    if consts is None:
        consts = fetch_consts(fetches, xs.device)
    if cdt is None or grad_mode == "scatter":
        return gather_combine_pos(table, idx, xs, ys, zs, consts, F, offset, cdt)
    return _LookupCombinePos.apply(table, idx, xs, ys, zs, tuple(fetches), consts, F, offset, cdt)


# ---------------------------------------------------------------------------
# K3: per-cell max
# ---------------------------------------------------------------------------

_NEG_ONE_BITS = int(np.array(-1.0, np.float32).view(np.int32))


def cell_max_plain(ids: Tensor, vals: Tensor, n_cells: int) -> Tensor:
    """K3's plain version: the kernel's max on the int32 bit patterns (which
    order like the values for non-negative floats), from ``-1.0``."""
    out = torch.full((n_cells,), _NEG_ONE_BITS, dtype=torch.int32, device=vals.device)
    bits = vals.view(torch.int32)
    bits = torch.where(bits == torch.iinfo(torch.int32).min, 0, bits)  # -0.0 counts as 0.0
    return out.scatter_reduce_(0, ids.long(), bits, reduce="amax").view(torch.float32)


def _cell_max_lib():
    return _lib("cell_max", (
        ("cell_max_launch", (_P,) * 3 + (ctypes.c_longlong, ctypes.c_int, _P)),
    ))


def cell_max(ids: Tensor, vals: Tensor, n_cells: int) -> Tensor:
    """Kernel K3: ``(n_cells,)`` float32, the max of the non-negative
    ``vals`` whose ``ids`` name each cell and ``-1`` where none does, equal
    to ``full(-1).scatter_reduce(ids, vals, "amax")``.  ``ids`` int32 in
    ``[0, n_cells)`` (the kernel skips others).  A CPU tensor takes
    :func:`cell_max_plain`; a CUDA tensor launches the kernel or raises.
    The kernel writes every cell, the ``-1`` of the untouched ones too."""
    if vals.device.type == "cpu":
        return cell_max_plain(ids, vals, n_cells)
    if vals.device.type != "cuda":
        raise ValueError(f"cell_max: unsupported device {vals.device}")
    if ids.dtype != torch.int32 or ids.ndim != 1 or not ids.is_contiguous():
        raise ValueError("cell_max: ids must be contiguous 1-D int32")
    if vals.dtype != torch.float32 or vals.shape != ids.shape or not vals.is_contiguous():
        raise ValueError("cell_max: vals must be contiguous float32 like ids")
    if ids.device != vals.device:
        raise ValueError("cell_max: all tensors must be on one device")
    if n_cells <= 0 or n_cells >= 1 << 31:
        raise ValueError(f"cell_max: n_cells={n_cells} out of range")
    lib = _cell_max_lib()
    out = torch.empty((n_cells,), dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.cell_max_launch(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), ids.numel(), n_cells, stream
        )
    _build.check(lib, rc, "cell_max_launch")
    cell_max.launches += 1
    return out


cell_max.launches = 0  # kernel launches since the count was last reset
