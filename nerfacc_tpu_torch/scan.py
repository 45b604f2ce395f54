"""Segmented inclusive/exclusive sums and products.

Port of ``nerfacc_tpu/scan.py``.  Batched inputs scan along the last axis
with ``torch.cumsum``/``cumprod``.  Flat inputs are segmented by sorted
``ray_indices`` (or a ``packed_info`` table), and each segment's scan must
not inherit rounding error from the segments before it:

- sums take the flat cumulative sum in float64 and subtract the running
  total at each segment's start.  In float32 that difference cancels
  catastrophically once the running total is large (a 4096-ray round holds
  ~131k samples); float64's 53-bit mantissa leaves the float32 result exact
  to its last bit or two.  (The inference renderer has its samples in
  ``(n_rays, samples_per_round)`` rows and scans each row with the batched
  form instead.)
- products cannot subtract, and a zero anywhere would poison a division, so
  they run a log-depth segmented scan (Hillis-Steele over the (flag, value)
  monoid, the same monoid as the JAX package's ``associative_scan``): values
  from different segments are never combined.

Gradients come from autograd through these forms; for the flat sums they
are the reversed segmented sums the JAX package writes by hand
(``scan.py:142-179``).  The exact gradient of a product at a zero
(``scan.py:182-190``) is not ported.
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

__all__ = [
    "flags_from_ray_indices",
    "inclusive_sum",
    "exclusive_sum",
    "inclusive_prod",
    "exclusive_prod",
]


def flags_from_ray_indices(ray_indices: Tensor) -> Tensor:
    """Segment-start flags from sorted (row-major) ray indices."""
    flags = torch.ones(ray_indices.shape, dtype=torch.bool, device=ray_indices.device)
    if ray_indices.shape[0] > 1:
        flags[1:] = ray_indices[1:] != ray_indices[:-1]
    return flags


def flags_from_packed_info(packed_info: Tensor, n: int) -> Tensor:
    """Segment-start flags from an ``(n_rays, 2)`` (start, count) table."""
    flags = torch.zeros((n,), dtype=torch.bool, device=packed_info.device)
    starts = packed_info[:, 0][packed_info[:, 1] > 0]
    flags[starts.long()] = True
    if n:
        flags[0] = True
    return flags


def _resolve_flags(
    inputs: Tensor, packed_info: Optional[Tensor], ray_indices: Optional[Tensor]
) -> Tensor:
    assert inputs.ndim == 1, "flat scans require 1-D inputs"
    if ray_indices is not None:
        return flags_from_ray_indices(ray_indices)
    assert packed_info is not None
    assert packed_info.ndim == 2 and packed_info.shape[-1] == 2
    return flags_from_packed_info(packed_info, inputs.shape[0])


def _seg_sums(x: Tensor, flags: Tensor):
    """``(inclusive, exclusive)`` segmented sums, accumulated in float64."""
    csum = torch.cumsum(x.to(torch.float64), dim=0)
    prior = torch.cat([csum.new_zeros(1), csum[:-1]])  # total before element i
    # Index of each element's segment start (flags[0] is always set); a
    # cummax keeps this free of host synchronisation.
    pos = torch.arange(x.shape[0], device=x.device)
    start = torch.cummax(torch.where(flags, pos, 0), dim=0).values
    base = prior[start]
    return (csum - base).to(x.dtype), (prior - base).to(x.dtype)


def _seg_inclusive_prod(x: Tensor, flags: Tensor) -> Tensor:
    out = x.clone()
    f = flags.clone()
    n = x.shape[0]
    shift = 1
    while shift < n:
        # Combine element i with element i - shift unless a segment start lies
        # in (i - shift, i]; `f` marks that such a start has been seen.
        head, tail = out[:shift], out[shift:]
        tail = torch.where(f[shift:], tail, out[:-shift] * tail)
        out = torch.cat([head, tail])
        f = torch.cat([f[:shift], f[shift:] | f[:-shift]])
        shift *= 2
    return out


def inclusive_sum(
    inputs: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
) -> Tensor:
    """Inclusive sum over the last axis, or over flat per-ray segments."""
    if packed_info is None and ray_indices is None:
        return torch.cumsum(inputs, dim=-1)
    return _seg_sums(inputs, _resolve_flags(inputs, packed_info, ray_indices))[0]


def exclusive_sum(
    inputs: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
) -> Tensor:
    """Exclusive sum: zero at each segment's first element."""
    if packed_info is None and ray_indices is None:
        shifted = torch.cat(
            [torch.zeros_like(inputs[..., :1]), inputs[..., :-1]], dim=-1
        )
        return torch.cumsum(shifted, dim=-1)
    return _seg_sums(inputs, _resolve_flags(inputs, packed_info, ray_indices))[1]


def inclusive_prod(
    inputs: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
) -> Tensor:
    """Inclusive product over the last axis or over flat segments."""
    if packed_info is None and ray_indices is None:
        return torch.cumprod(inputs, dim=-1)
    return _seg_inclusive_prod(inputs, _resolve_flags(inputs, packed_info, ray_indices))


def exclusive_prod(
    inputs: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
) -> Tensor:
    """Exclusive product: one at each segment's first element."""
    if packed_info is None and ray_indices is None:
        shifted = torch.cat(
            [torch.ones_like(inputs[..., :1]), inputs[..., :-1]], dim=-1
        )
        return torch.cumprod(shifted, dim=-1)
    flags = _resolve_flags(inputs, packed_info, ray_indices)
    inc = _seg_inclusive_prod(inputs, flags)
    shifted = torch.cat([torch.ones_like(inc[:1]), inc[:-1]])
    return torch.where(flags, torch.ones_like(inc), shifted)
