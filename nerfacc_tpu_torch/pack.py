"""Packing helpers: ``ray_indices`` to ``packed_info``, and count-based
compaction of row-prefix-valid layouts.

Port of ``nerfacc_tpu/pack.py:24-114``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

__all__ = ["pack_info", "compact_indices_from_counts"]


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
