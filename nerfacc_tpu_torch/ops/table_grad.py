"""Fused hash-table gradient (kernels K2 and K4-w3) and per-cell max (K3).

Port of ``nerfacc_tpu/ops/table_grad.py``:

- :func:`hash_lookup_combine3` is the fused encoder's gather plus trilinear
  combine as a ``torch.autograd.Function`` (``table_grad.py:1012-1320``).
  Its backward never builds the ``(N, 128)`` cotangent: it sorts the
  samples by table row and hands the rank-1 factors (three fractional cell
  weights and the ``F = 16`` output cotangent of each sample) to a kernel
  that rebuilds and sums them per row.  Zero gradient goes to the weights,
  none to the rows.
- K2, :func:`table_grad_u10` (bf16 compute; replaces
  ``table_grad_factors_sorted_u10``): the weights quantised to 10 bits,
  each corner weight and each product rounded to bf16, sums in float32.
  A weight's complement ``1 - q/1023`` is rounded once, as XLA computes it
  (it contracts ``1 - q * (1/1023)`` into a fused multiply-add); rounding
  twice flips about one corner weight in a thousand by a bf16 step.
- K4 in its ``w3`` mode, :func:`table_grad_w3` (float32 compute; replaces
  ``table_grad_factors_sorted(wpack="w3")``): float32 throughout.
- K3, :func:`cell_max` (replaces ``cell_max_sorted``): the exact
  ``full(-1).at[ids].max(vals)`` for non-negative ``vals``.

On a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/table_grad.cu``, ``csrc/cell_max.cu``) or raises; on a CPU tensor it
runs the plain PyTorch version beside it, which does the kernel's
arithmetic term for term.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import _build

Tensor = torch.Tensor

F_PER_ROW = 16  # features per corner: 8 corners x 16 = a 128-wide table row
ROW_WIDTH = 8 * F_PER_ROW
_INV_1023 = float(np.float32(1.0 / 1023.0))  # the JAX kernel's dequantisation step


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
# K2 and K4-w3: per-row sums of the rank-1 cotangents
# ---------------------------------------------------------------------------


def table_grad_u10_plain(
    sorted_idx: Tensor, perm: Tensor, wq: Tensor, dout: Tensor, n_rows: int
) -> Tensor:
    """K2's plain version: ``out[r, c*16+f] = sum_{i: idx_i = r}
    bf16(bf16(w_c(i)) * dout_i[f])`` in float32.  Sample ``sorted_idx[k]`` is sample ``perm[k]`` of
    ``wq (N,)`` and ``dout (N, 16)`` bf16, ``w_c`` from
    :func:`u10_corner_weights`."""
    p = perm.long()
    w8 = u10_corner_weights(wq[p]).to(torch.bfloat16).to(torch.float32)
    d = dout[p].to(torch.float32)
    terms = (w8[:, :, None] * d[:, None, :]).to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((n_rows, ROW_WIDTH), dtype=torch.float32, device=dout.device)
    return out.index_add_(0, sorted_idx.long(), terms.reshape(-1, ROW_WIDTH))


def table_grad_w3_plain(
    sorted_idx: Tensor, perm: Tensor, wx: Tensor, wy: Tensor, wz: Tensor,
    dout: Tensor, n_rows: int,
) -> Tensor:
    """K4-w3's plain version: the sum of :func:`table_grad_u10_plain` with
    float32 weights, products and sums (``dout (N, 16)`` float32)."""
    p = perm.long()
    w8 = corner_weights(wx[p], wy[p], wz[p])
    terms = w8[:, :, None] * dout[p][:, None, :]
    out = torch.zeros((n_rows, ROW_WIDTH), dtype=torch.float32, device=dout.device)
    return out.index_add_(0, sorted_idx.long(), terms.reshape(-1, ROW_WIDTH))


@functools.lru_cache(maxsize=None)
def _table_grad_lib():
    lib = _build.load("table_grad")
    for name, n_weight_ptrs in (("table_grad_u10_launch", 1), ("table_grad_w3_launch", 3)):
        fn = getattr(lib, name)
        fn.argtypes = (
            [ctypes.c_void_p] * (2 + n_weight_ptrs + 2)
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def _check_sorted_args(name, sorted_idx, perm, dout, dout_dtype, n_rows):
    n = sorted_idx.shape[0]
    if sorted_idx.dtype != torch.int32 or sorted_idx.ndim != 1 or not sorted_idx.is_contiguous():
        raise ValueError(f"{name}: sorted_idx must be contiguous 1-D int32")
    if perm.dtype != torch.int64 or perm.shape != (n,) or not perm.is_contiguous():
        raise ValueError(f"{name}: perm must be contiguous int64 of sorted_idx's length")
    if dout.dtype != dout_dtype or dout.shape != (n, F_PER_ROW) or not dout.is_contiguous():
        raise ValueError(f"{name}: dout must be contiguous ({n}, {F_PER_ROW}) {dout_dtype}")
    for t in (perm, dout):
        if t.device != sorted_idx.device:
            raise ValueError(f"{name}: all tensors must be on one device")
    if n_rows <= 0 or n_rows >= 1 << 31:
        raise ValueError(f"{name}: n_rows={n_rows} out of range")


# Samples per warp: each warp reduces one contiguous span of sorted samples.
_SPAN = 128


def _launch_table_grad(fn_name, sorted_idx, perm, weights, dout, n_rows):
    lib = _table_grad_lib()
    out = torch.zeros((n_rows, ROW_WIDTH), dtype=torch.float32, device=dout.device)
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        rc = getattr(lib, fn_name)(
            sorted_idx.data_ptr(), perm.data_ptr(), *[w.data_ptr() for w in weights],
            dout.data_ptr(), out.data_ptr(), sorted_idx.shape[0], _SPAN, _INV_1023, stream,
        )
    _build.check(lib, rc, fn_name)
    return out


def table_grad_u10(
    sorted_idx: Tensor, perm: Tensor, wq: Tensor, dout: Tensor, n_rows: int
) -> Tensor:
    """Kernel K2: the ``(n_rows, 128)`` float32 table gradient from rows
    sorted ascending (``sorted_idx`` int32, in ``[0, n_rows)``), the
    permutation that sorted them (``perm`` int64), u10 weights ``wq`` int32
    and ``dout (N, 16)`` bf16, both in unsorted sample order.  A CPU tensor
    takes :func:`table_grad_u10_plain`; a CUDA tensor launches the kernel
    (one launch for all levels) or raises."""
    if dout.device.type == "cpu":
        return table_grad_u10_plain(sorted_idx, perm, wq, dout, n_rows)
    if dout.device.type != "cuda":
        raise ValueError(f"table_grad_u10: unsupported device {dout.device}")
    _check_sorted_args("table_grad_u10", sorted_idx, perm, dout, torch.bfloat16, n_rows)
    if wq.dtype != torch.int32 or wq.shape != perm.shape or not wq.is_contiguous() or wq.device != dout.device:
        raise ValueError("table_grad_u10: wq must be contiguous int32 like perm, on its device")
    out = _launch_table_grad("table_grad_u10_launch", sorted_idx, perm, [wq], dout, n_rows)
    table_grad_u10.launches += 1
    return out


table_grad_u10.launches = 0  # kernel launches since the count was last reset


def table_grad_w3(
    sorted_idx: Tensor, perm: Tensor, wx: Tensor, wy: Tensor, wz: Tensor,
    dout: Tensor, n_rows: int,
) -> Tensor:
    """Kernel K4 in ``w3`` mode: :func:`table_grad_u10`'s sum with float32
    weights ``wx, wy, wz`` and float32 ``dout (N, 16)``.  A CPU tensor
    takes :func:`table_grad_w3_plain`; a CUDA tensor launches the kernel or
    raises."""
    if dout.device.type == "cpu":
        return table_grad_w3_plain(sorted_idx, perm, wx, wy, wz, dout, n_rows)
    if dout.device.type != "cuda":
        raise ValueError(f"table_grad_w3: unsupported device {dout.device}")
    _check_sorted_args("table_grad_w3", sorted_idx, perm, dout, torch.float32, n_rows)
    for w in (wx, wy, wz):
        if w.dtype != torch.float32 or w.shape != perm.shape or not w.is_contiguous() or w.device != dout.device:
            raise ValueError("table_grad_w3: wx, wy, wz must be contiguous float32 like perm, on its device")
    out = _launch_table_grad("table_grad_w3_launch", sorted_idx, perm, [wx, wy, wz], dout, n_rows)
    table_grad_w3.launches += 1
    return out


table_grad_w3.launches = 0  # kernel launches since the count was last reset


def table_grad_factors(
    idx: Tensor, wx: Tensor, wy: Tensor, wz: Tensor, dout: Tensor, n_rows: int
) -> Tensor:
    """The table gradient of :func:`hash_lookup_combine3`: sort the rows
    (``torch.sort``, outside the kernel, as the JAX package sorts outside
    its Pallas kernel), then K2 for a bf16 ``dout`` or K4-w3 for float32."""
    sorted_idx, perm = torch.sort(idx.to(torch.int32))
    if dout.dtype == torch.bfloat16:
        wq = quantize_u10(wx, wy, wz)
        return table_grad_u10(sorted_idx, perm, wq, dout.contiguous(), n_rows)
    if dout.dtype == torch.float32:
        return table_grad_w3(
            sorted_idx, perm, wx.contiguous(), wy.contiguous(), wz.contiguous(),
            dout.contiguous(), n_rows,
        )
    raise ValueError(f"table_grad_factors: dout must be bf16 or float32, got {dout.dtype}")


def gather_combine(
    table: Tensor, idx: Tensor, wx: Tensor, wy: Tensor, wz: Tensor,
    offset: float, compute_dtype: Optional[torch.dtype],
) -> Tensor:
    """Rows ``idx`` of ``table - offset`` (cast to ``compute_dtype`` if
    given), each ``8 * F`` wide, combined over their 8 corners with the
    trilinear weights of ``(wx, wy, wz)``: ``(N, F)``.  Autograd
    differentiates it as written; :func:`hash_lookup_combine3` gives it the
    factor backward."""
    t = table - offset
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    w = corner_weights(wx, wy, wz).to(t.dtype)
    return torch.einsum("kc,kcf->kf", w, t[idx].view(-1, 8, table.shape[1] // 8))


class _LookupCombine3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, wx, wy, wz, offset, compute_dtype):
        out = gather_combine(table, idx, wx, wy, wz, offset, compute_dtype)
        ctx.save_for_backward(idx, wx, wy, wz)
        ctx.n_rows = table.shape[0]
        return out

    @staticmethod
    def backward(ctx, dout):
        idx, wx, wy, wz = ctx.saved_tensors
        with record_function("table_grad"):
            dtable = table_grad_factors(idx, wx, wy, wz, dout, ctx.n_rows)
        zero = [torch.zeros_like(w) if need else None for w, need in zip((wx, wy, wz), ctx.needs_input_grad[2:5])]
        return (dtable, None, *zero, None, None)


def hash_lookup_combine3(
    table: Tensor,
    idx: Tensor,
    wx: Tensor,
    wy: Tensor,
    wz: Tensor,
    offset: float = 0.0,
    compute_dtype: Optional[torch.dtype] = None,
) -> Tensor:
    """Gather rows ``idx`` of ``table - offset`` (``(n_rows, 128)`` float32,
    cast to ``compute_dtype`` if given) and combine each row's 8 corners of
    16 features with the trilinear weights of ``(wx, wy, wz)``: ``(N, 16)``
    in the compute dtype.  Backward: the table gradient through K2 (bf16) or
    K4-w3 (float32), zero to the weights, none to ``idx``."""
    if table.ndim != 2 or table.shape[1] != ROW_WIDTH:
        raise ValueError(f"hash_lookup_combine3: table must be (n_rows, {ROW_WIDTH})")
    if compute_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"hash_lookup_combine3: compute_dtype {compute_dtype} not supported")
    if compute_dtype == torch.float32:
        compute_dtype = None
    return _LookupCombine3.apply(table, idx, wx, wy, wz, offset, compute_dtype)


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


@functools.lru_cache(maxsize=None)
def _cell_max_lib():
    lib = _build.load("cell_max")
    lib.cell_max_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    )
    lib.cell_max_launch.restype = ctypes.c_int
    return lib


def cell_max(ids: Tensor, vals: Tensor, n_cells: int) -> Tensor:
    """Kernel K3: ``(n_cells,)`` float32, the max of the non-negative
    ``vals`` whose ``ids`` name each cell and ``-1`` where none does, equal
    to ``full(-1).scatter_reduce(ids, vals, "amax")``.  ``ids`` int32 in
    ``[0, n_cells)`` (the kernel skips others).  A CPU tensor takes
    :func:`cell_max_plain`; a CUDA tensor launches the kernel or raises."""
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
    out = torch.full((n_cells,), -1.0, dtype=torch.float32, device=vals.device)
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        rc = lib.cell_max_launch(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), ids.numel(), n_cells, stream
        )
    _build.check(lib, rc, "cell_max_launch")
    cell_max.launches += 1
    return out


cell_max.launches = 0  # kernel launches since the count was last reset
