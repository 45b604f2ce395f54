"""Occupancy query over a bit-packed multi-level grid (kernel K1).

Port of ``nerfacc_tpu/ops/occ_query.py``.  :func:`occupancy_query` answers
"is the cell containing point p occupied?" for every point, with the
mip-level semantics of :func:`_query_soa` (the counterpart of
``nerfacc_tpu.grid._query_soa``).  On a CUDA tensor it launches the
hand-written kernel ``csrc/occ_query.cu``; on a CPU tensor it runs
:func:`occupancy_query_plain`, the same arithmetic in PyTorch.

Packed layout: ``(levels, rx, ry, ceil(rz / 32))`` int32 words; bit ``b`` of
word ``[l, ix, iy, w]`` is cell ``(l, ix, iy, 32 * w + b)``.  Unlike the TPU
layout (``(rx, ry * words)`` padded to 128 lanes) nothing is padded.

Non-finite points are part of the contract: the JAX kernel pads its queries
with ``+inf``.  Such a point takes mip level 1 (``frexp`` of ``inf`` or NaN
has exponent 0), so at two or more levels its cell is looked up, and the
float-to-int32 cast of its coordinate decides which.  XLA's cast saturates
(NaN to 0, out-of-range values to the int32 limits), as CUDA's
``cvt.rzi.s32.f32`` does; PyTorch's ``.to(torch.int32)`` on the CPU maps
all of them to ``-2^31``.  :func:`_cells` therefore casts through
:func:`_trunc_int32`, which saturates.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import _build

Tensor = torch.Tensor


def bitpack_grid(binaries: Tensor) -> Tensor:
    """Pack a ``(levels, rx, ry, rz)`` bool grid into ``(levels, rx, ry,
    ceil(rz / 32))`` int32 words (bit ``b`` of word ``w`` is cell
    ``32 * w + b`` along z)."""
    if binaries.ndim != 4:
        raise ValueError(f"bitpack_grid: binaries must be (levels, rx, ry, rz), got {tuple(binaries.shape)}")
    levels, rx, ry, rz = binaries.shape
    words = -(-rz // 32)
    bits = torch.zeros(
        (levels, rx, ry, words * 32), dtype=torch.int64, device=binaries.device
    )
    bits[..., :rz] = binaries.to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=binaries.device)
    w = (bits.view(levels, rx, ry, words, 32) << shifts).sum(-1)
    # Words are unsigned 32-bit patterns; store them as int32 two's complement.
    w = torch.where(w >= 1 << 31, w - (1 << 32), w)
    return w.to(torch.int32).contiguous()


def _normalized(px: Tensor, py: Tensor, pz: Tensor, base_aabb: Tensor):
    nx = (px - base_aabb[0]) / (base_aabb[3] - base_aabb[0]) - 0.5
    ny = (py - base_aabb[1]) / (base_aabb[4] - base_aabb[1]) - 0.5
    nz = (pz - base_aabb[2]) / (base_aabb[5] - base_aabb[2]) - 0.5
    return nx, ny, nz


def _mip(nx: Tensor, ny: Tensor, nz: Tensor) -> Tensor:
    maxval = torch.maximum(torch.maximum(nx.abs(), ny.abs()), nz.abs())
    # frexp of ~0 yields exponent 0; clamp as the reference does.
    maxval = maxval.clamp(min=0.1)
    _, exponent = torch.frexp(maxval)
    return (exponent + 1).clamp(min=0)


def _trunc_int32(v: Tensor) -> Tensor:
    """Float to int32 toward zero, saturating as XLA's cast does: NaN to 0,
    values beyond the int32 range (``+-inf`` too) to the float32 nearest
    inside it, ``-2^31`` or ``2^31 - 128``."""
    v = torch.where(torch.isnan(v), 0.0, v).clamp(-2147483648.0, 2147483520.0)
    return v.to(torch.int32)


def _cells(nx, ny, nz, mip, levels: int, res: Sequence[int], mip_pad: int):
    """Yield ``(mip_p, ix, iy, iz)`` for each level the lookup unions."""
    rx, ry, rz = res
    for dp in range(mip_pad + 1):
        mip_p = (mip + dp).clamp(max=levels - 1)
        inv_scale = torch.exp2(-mip_p.to(nx.dtype))

        def cell(coord, r, s=inv_scale):
            return _trunc_int32((coord * s + 0.5) * r).clamp(0, r - 1)

        yield mip_p, cell(nx, rx), cell(ny, ry), cell(nz, rz)


def _query_soa(
    px: Tensor,
    py: Tensor,
    pz: Tensor,
    data: Tensor,
    base_aabb: Tensor,
    mip_pad: int = 0,
) -> Tuple[Tensor, Tensor]:
    """Mip-level lookup in a ``(levels, rx, ry, rz)`` bool grid.

    Port of ``nerfacc_tpu/grid.py:_query_soa`` for bool grids: returns
    ``(occupied, selector)``, where ``selector`` marks points inside the
    outermost level and ``mip_pad > 0`` unions the lookup over levels
    ``mip .. mip+pad``.
    """
    levels, rx, ry, rz = data.shape
    nx, ny, nz = _normalized(px, py, pz, base_aabb)
    mip = _mip(nx, ny, nz)
    selector = mip < levels
    flat = data.reshape(-1)
    out = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for mip_p, ix, iy, iz in _cells(nx, ny, nz, mip, levels, (rx, ry, rz), mip_pad):
        idx = ((mip_p.long() * rx + ix) * ry + iy) * rz + iz
        out = out | flat[idx.reshape(-1)].reshape(px.shape)
    return out & selector, selector


def occupancy_query_plain(
    packed: Tensor,
    base_aabb: Tensor,
    px: Tensor,
    py: Tensor,
    pz: Tensor,
    rz: int,
    mip_pad: int = 0,
) -> Tensor:
    """The kernel's plain PyTorch version: :func:`_query_soa` reading bits of
    the packed grid.  Returns bool shaped like ``px``."""
    levels, rx, ry, words = packed.shape
    nx, ny, nz = _normalized(px, py, pz, base_aabb)
    mip = _mip(nx, ny, nz)
    flat = packed.reshape(-1)
    out = torch.zeros(px.shape, dtype=torch.int32, device=px.device)
    for mip_p, ix, iy, iz in _cells(nx, ny, nz, mip, levels, (rx, ry, rz), mip_pad):
        word = ((mip_p.long() * rx + ix) * ry + iy) * words + (iz >> 5)
        out = out | ((flat[word] >> (iz & 31)) & 1)
    return out.to(torch.bool) & (mip < levels)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("occ_query")
    fn = lib.occ_query_launch
    fn.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 6
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib, fn


def occupancy_query(
    packed: Tensor,
    base_aabb: Tensor,
    px: Tensor,
    py: Tensor,
    pz: Tensor,
    rz: int,
    mip_pad: int = 0,
) -> Tensor:
    """Occupancy of the cells containing ``(px, py, pz)``, all levels.

    ``packed`` is ``(levels, rx, ry, ceil(rz / 32))`` int32 from
    :func:`bitpack_grid`; ``base_aabb`` the ``(6,)`` level-0 box, with level
    ``l`` the ``2^l``-enlarged box.  Returns bool shaped like ``px``.  A CPU
    tensor takes :func:`occupancy_query_plain`; a CUDA tensor launches the
    kernel (one launch for all levels) or raises.  The kernel reads each
    coordinate array 16 bytes at a time, so on the card they must be
    16-byte aligned, as fresh tensors are, and it unions at most two levels
    (``mip_pad`` 0 or 1).
    """
    if px.device.type == "cpu":
        return occupancy_query_plain(packed, base_aabb, px, py, pz, rz, mip_pad)
    if px.device.type != "cuda":
        raise ValueError(f"occupancy_query: unsupported device {px.device}")
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"occupancy_query: {name} must be contiguous float32")
        if t.shape != px.shape or t.device != px.device:
            raise ValueError("occupancy_query: px, py, pz must match in shape and device")
        if t.data_ptr() % 16:
            raise ValueError(f"occupancy_query: {name} must be 16-byte aligned (the kernel reads it 16 bytes at a time)")
    if mip_pad not in (0, 1):
        raise ValueError(f"occupancy_query: mip_pad={mip_pad}; the kernel unions at most two levels (0 or 1)")
    if packed.dtype != torch.int32 or packed.ndim != 4 or not packed.is_contiguous():
        raise ValueError("occupancy_query: packed must be contiguous (levels, rx, ry, words) int32")
    if packed.shape[0] > 126 or packed.numel() >= 1 << 31:
        raise ValueError("occupancy_query: packed must have at most 126 levels and fewer than 2^31 words")
    if packed.shape[3] != -(-rz // 32):
        raise ValueError(f"occupancy_query: packed has {packed.shape[3]} words per row, rz={rz} needs {-(-rz // 32)}")
    if base_aabb.dtype != torch.float32 or base_aabb.numel() != 6 or not base_aabb.is_contiguous():
        raise ValueError("occupancy_query: base_aabb must be 6 contiguous float32")
    if packed.device != px.device or base_aabb.device != px.device:
        raise ValueError("occupancy_query: all tensors must be on one device")

    lib, fn = _launcher()
    levels, rx, ry, words = packed.shape
    out = torch.empty(px.shape, dtype=torch.bool, device=px.device)
    with torch.cuda.device(px.device):
        stream = torch.cuda.current_stream(px.device).cuda_stream
        rc = fn(
            px.data_ptr(), py.data_ptr(), pz.data_ptr(), packed.data_ptr(),
            base_aabb.data_ptr(), out.data_ptr(), px.numel(),
            levels, rx, ry, rz, words, mip_pad, stream,
        )
    _build.check(lib, rc, "occ_query_launch")
    occupancy_query.launches += 1
    return out


occupancy_query.launches = 0  # kernel launches since the count was last reset
