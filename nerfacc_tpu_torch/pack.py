"""Packing helpers: ``ray_indices`` to ``packed_info``, batched to flat
layouts, and compaction of valid flat samples to a fixed capacity.

Port of ``nerfacc_tpu/pack.py:24-114``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["pack_info", "flatten_batched", "compact_flat", "compact_indices_from_counts"]


def pack_info(
    ray_indices: Tensor, n_rays: int, is_valid: Optional[Tensor] = None
) -> Tensor:
    """``(n_rays, 2)`` (chunk_start, chunk_cnt) int32 from sorted ``ray_indices``.

    With ``is_valid``, counts only valid samples; chunk_start still points at
    the first slot of the ray's region (every slot counts there).
    """
    assert ray_indices.ndim == 1
    ri = ray_indices.long()
    all_cnts = torch.bincount(ri, minlength=n_rays)[:n_rays]
    starts = torch.cumsum(all_cnts, 0) - all_cnts
    cnts = all_cnts
    if is_valid is not None:
        cnts = torch.zeros_like(all_cnts).index_add_(0, ri, is_valid.long())
    return torch.stack([starts, cnts], dim=-1).to(torch.int32)


def flatten_batched(*vals: Tensor) -> Tuple[Tensor, ...]:
    """Flatten ``(n_rays, S, ...)`` tensors to ``(n_rays * S, ...)`` and
    append the row-major ``ray_indices`` (int32)."""
    n_rays, s = vals[0].shape[:2]
    ray_indices = torch.arange(
        n_rays, dtype=torch.int32, device=vals[0].device
    ).repeat_interleave(s)
    flat = tuple(v.reshape((n_rays * s,) + tuple(v.shape[2:])) for v in vals)
    return flat + (ray_indices,)


def compact_flat(is_valid: Tensor, capacity: int) -> Tuple[Tensor, Tensor]:
    """``(gather_idx (capacity,), kept (capacity,))`` that move the valid
    flat samples to the front, in order: a stable argsort of ``~is_valid``,
    cut to ``capacity``.  ``kept`` marks the slots that hold a valid
    sample."""
    order = torch.argsort((~is_valid).to(torch.int8), stable=True)
    gather_idx = order[:capacity]
    kept = torch.arange(capacity, device=is_valid.device) < is_valid.sum()
    return gather_idx, kept


def compact_indices_from_counts(
    num_valid: Tensor, row_capacity: int, capacity: int
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sort-free compaction of a ``(rows, row_capacity)`` row-prefix layout.

    Output slot ``k`` holds row ``r = searchsorted(cum, k, right) - 1`` at
    offset ``j = k - cum[r]``, i.e. flat source ``r * row_capacity + j``.
    Returns ``(gather_idx, ray_ids, kept)``, each ``(capacity,)``; ``kept``
    masks slots past the total valid count, and those padding slots decode
    to the last row (so ``ray_ids`` stays sorted).
    """
    cnt = num_valid.to(torch.int32)
    cum = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt  # exclusive
    total = cum[-1] + cnt[-1]
    k = torch.arange(capacity, dtype=torch.int32, device=num_valid.device)
    r = torch.searchsorted(cum, k, right=True).to(torch.int32) - 1
    r = r.clamp(0, num_valid.shape[0] - 1)
    j = k - cum[r.long()]
    gather_idx = r.long() * row_capacity + j.clamp(0, row_capacity - 1)
    kept = k < total
    return gather_idx, r, kept
