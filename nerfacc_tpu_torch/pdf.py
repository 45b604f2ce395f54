"""Inverse-CDF importance sampling and segmented searchsorted.

Port of ``nerfacc_tpu/pdf.py:29-352``.  Each ray row is searched with
``torch.searchsorted(..., right=True)``; the flat layout runs a vectorised
binary search over each ray's chunk of ``packed_info``.  Stratified
sampling draws one uniform ``bias`` a ray (``pdf.py:217-221``): pass it as
``jitter`` (``(n_rays, 1)`` or ``(n_rays,)``), or it is drawn from
``generator``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from .data_specs import RayIntervals, RaySamples

Tensor = torch.Tensor

__all__ = ["searchsorted", "importance_sampling"]


def _searchsorted_clamped(sorted_vals: Tensor, values: Tensor) -> Tuple[Tensor, Tensor]:
    """Row-wise upper bound with the reference's clamps (``pdf.cu:245-286``):
    ``p = upper_bound(row, v)`` clamped to ``n - 1``, then ``ids_left =
    max(p - 1, 0)``, ``ids_right = p``.  Both inputs are ``(..., n)`` and
    ``(..., m)`` with the same leading shape; returns per-row int64 indices
    of ``values``'s shape."""
    n = sorted_vals.shape[-1]
    rows = sorted_vals.reshape(-1, n).contiguous()
    v = values.reshape(-1, values.shape[-1]).contiguous()
    p = torch.searchsorted(rows, v, right=True).clamp(max=n - 1)
    return (p - 1).clamp(min=0).reshape(values.shape), p.reshape(values.shape)


def searchsorted(
    sorted_sequence: Union[RayIntervals, RaySamples],
    values: Union[RayIntervals, RaySamples],
) -> Tuple[Tensor, Tensor]:
    """Segmented searchsorted (``pdf.py:51-65``): ``(ids_left, ids_right)``
    with ``sorted[ids_left] <= value < sorted[ids_right]``, clamped to the
    row.  Batched inputs give per-row indices; flat inputs flat indices into
    ``sorted_sequence.vals``."""
    if sorted_sequence.is_batched and values.is_batched:
        return _searchsorted_clamped(sorted_sequence.vals, values.vals)
    return _searchsorted_flat(sorted_sequence, values)


def _searchsorted_flat(key, query) -> Tuple[Tensor, Tensor]:
    """Flat segmented searchsorted (``pdf.py:68-108``): each query value
    searches ``[base, last)`` of its ray's chunk of ``key`` (from the two
    ``packed_info`` tables); the ids are flat, clamped to ``[base, last]``."""
    if query.packed_info is None or key.packed_info is None:
        raise ValueError("flat searchsorted needs packed_info on both sides")
    qvals, kvals = query.vals, key.vals
    dev = qvals.device
    nq, nk = qvals.shape[0], kvals.shape[0]
    q_starts = query.packed_info[:, 0].long().contiguous()
    ray_id = torch.searchsorted(q_starts, torch.arange(nq, device=dev), right=True) - 1
    ray_id = ray_id.clamp(0, query.packed_info.shape[0] - 1)
    base = key.packed_info[ray_id, 0].long()
    cnt = key.packed_info[ray_id, 1].long()
    last = base + (cnt - 1).clamp(min=0)
    lo, hi = base, last  # upper bound over [base, last): least p with key[p] > v
    for _ in range(max(1, nk.bit_length())):
        mid = (lo + hi) // 2
        km = kvals[mid.clamp(0, max(nk - 1, 0))]
        go_right = (km <= qvals) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return (lo - 1).clamp(base, last), lo.clamp(base, last)


def _bias(n_rays: int, like: Tensor, stratified: bool, jitter, generator) -> Tensor:
    """Each ray's offset in its sample cell: 0.5, or stratified ``jitter``
    (drawn from ``generator`` when not given)."""
    if not stratified:
        return torch.full((n_rays, 1), 0.5, dtype=like.dtype, device=like.device)
    if jitter is None:
        return torch.rand((n_rays, 1), generator=generator, dtype=like.dtype, device=like.device)
    return jitter.to(like.dtype).reshape(n_rays, 1)


def importance_sampling(
    intervals: RayIntervals,
    cdfs: Tensor,
    n_intervals_per_ray: Union[int, Tensor],
    stratified: bool = False,
    jitter: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    max_intervals_per_ray: Optional[int] = None,
    max_edges_per_ray: Optional[int] = None,
) -> Tuple[RayIntervals, RaySamples]:
    """Inverse-transform resampling of intervals from CDF values at their
    edges (``pdf.py:111-282``).  Returns ``(intervals (n_rays, n + 1),
    samples (n_rays, n))``.

    - Batched, one count: ``n_intervals_per_ray`` an int.
    - Batched, per-ray counts: an int tensor of counts with a capacity
      ``max_intervals_per_ray``; the outputs are batched at the capacity
      with ``is_valid`` / ``is_left`` / ``is_right``, and each ray's last
      edge extrapolates its last sample by half its trailing gap, clamped
      to ``t_max`` (``pdf.py:240-282``).
    - Flat: ``intervals`` and ``cdfs`` flat with ``packed_info`` and a bound
      ``max_edges_per_ray`` on edges a ray; every ray is resampled to
      ``n_intervals_per_ray`` intervals and returned flat.

    A sample whose CDF span is under 1e-10 takes its span's midpoint
    (``pdf.cu:157-160``).
    """
    if not intervals.is_batched:
        if intervals.packed_info is None or max_edges_per_ray is None:
            raise ValueError("flat importance_sampling needs packed_info and max_edges_per_ray")
        if not isinstance(n_intervals_per_ray, int):
            raise ValueError("flat importance_sampling takes one int count")
        dev = intervals.vals.device
        starts = intervals.packed_info[:, 0].long()
        cnts = intervals.packed_info[:, 1].long()
        n_rays_f, total = starts.shape[0], intervals.vals.shape[0]
        j = torch.arange(int(max_edges_per_ray), device=dev)
        # Each ray's edges padded by repeating its last edge: the padded cdf
        # is constant, so no resampled point lands there.
        idx = starts[:, None] + torch.minimum(j[None, :], (cnts[:, None] - 1).clamp(min=0))
        idx = idx.clamp(0, max(total - 1, 0))
        iv_b, s_b = importance_sampling(
            RayIntervals(vals=intervals.vals[idx]), cdfs[idx], n_intervals_per_ray,
            stratified=stratified, jitter=jitter, generator=generator,
        )
        n = n_intervals_per_ray
        ray_ok = cnts >= 2  # a ray needs two edges to hold an interval
        rows = torch.arange(n_rays_f, dtype=torch.int32, device=dev)
        edge_left = torch.arange(n + 1, device=dev) < n
        return (
            RayIntervals(
                vals=iv_b.vals.reshape(-1),
                packed_info=torch.stack([rows * (n + 1), torch.full_like(rows, n + 1)], -1),
                ray_indices=rows.repeat_interleave(n + 1),
                is_left=(edge_left[None, :] & ray_ok[:, None]).reshape(-1),
                is_right=(edge_left.flip(0)[None, :] & ray_ok[:, None]).reshape(-1),
            ),
            RaySamples(
                vals=s_b.vals.reshape(-1),
                packed_info=torch.stack([rows * n, torch.full_like(rows, n)], -1),
                ray_indices=rows.repeat_interleave(n),
                is_valid=ray_ok.repeat_interleave(n),
            ),
        )

    vals = intervals.vals  # (n_rays, n_edges)
    n_rays, dt, dev = vals.shape[0], vals.dtype, vals.device
    per_ray = not isinstance(n_intervals_per_ray, int)
    if per_ray:
        if max_intervals_per_ray is None:
            raise ValueError("per-ray counts need a max_intervals_per_ray capacity")
        n = int(max_intervals_per_ray)
        n_arr = torch.as_tensor(n_intervals_per_ray, device=dev).to(dt)[:, None]
    else:
        n = n_intervals_per_ray
        n_arr = torch.full((n_rays, 1), float(n), dtype=dt, device=dev)

    u_floor = cdfs[:, :1]
    u_step = (cdfs[:, -1:] - u_floor) / n_arr
    sid = torch.arange(n, dtype=dt, device=dev)
    u = u_floor + (sid + _bias(n_rays, vals, stratified, jitter, generator)) * u_step  # (n_rays, n)

    p0, p1 = _searchsorted_clamped(cdfs, u)
    u_lower, u_upper = cdfs.gather(-1, p0), cdfs.gather(-1, p1)
    t_lower, t_upper = vals.gather(-1, p0), vals.gather(-1, p1)
    du = u_upper - u_lower
    flat = du < 1e-10
    t = torch.where(
        flat,
        (t_lower + t_upper) * 0.5,
        (u - u_lower) * (t_upper - t_lower) / torch.where(flat, 1.0, du) + t_lower,
    )

    # Edges: midpoints between samples, the ends clamped to the input's
    # (compute_intervels_kernel, pdf.cu:169-241).
    t_min, t_max = vals[:, :1], vals[:, -1:]
    if n >= 2:
        mids = (t[:, 1:] + t[:, :-1]) * 0.5
        first = torch.maximum(t[:, :1] - (t[:, 1:2] - t[:, :1]) * 0.5, t_min)
        last = torch.minimum(t[:, -1:] + (t[:, -1:] - t[:, -2:-1]) * 0.5, t_max)
        edges = torch.cat([first, mids, last], dim=-1)
    else:
        edges = torch.cat([torch.maximum(t, t_min), torch.minimum(t, t_max)], dim=-1)
    if not per_ray:
        return RayIntervals(vals=edges), RaySamples(vals=t)

    # The count'th edge extrapolates the last valid sample by half its
    # trailing gap, clamped to t_max (pdf.cu:230-238), not the midpoint
    # against the capacity region's sample.  At a count of 1 the reference
    # leaves that edge unwritten; this takes the one-sample rule.
    eid = torch.arange(n + 1, dtype=dt, device=dev)
    c = n_arr.long().clamp(1, n)  # (n_rays, 1)
    t_last = t.gather(-1, c - 1)
    t_prev = t.gather(-1, (c - 2).clamp(min=0))
    last_val = torch.where(
        c >= 2, torch.minimum(t_last + (t_last - t_prev) * 0.5, t_max), torch.minimum(t_last, t_max)
    )
    edges = edges.scatter(-1, c, last_val)
    return (
        RayIntervals(vals=edges, is_left=eid[None, :] < n_arr, is_right=(eid[None, :] > 0) & (eid[None, :] <= n_arr)),
        RaySamples(vals=t, is_valid=sid[None, :] < n_arr),
    )


def _sample_from_weighted(
    bins: Tensor,
    weights: Tensor,
    num_samples: int,
    stratified: bool = False,
    vmin: Union[float, Tensor] = -math.inf,
    vmax: Union[float, Tensor] = math.inf,
    jitter: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """The reference oracle (``pdf.py:285-352``, ``nerfacc/pdf.py:134-219``):
    inverse-CDF sampling from a weighted histogram, for tests.  Stratified
    offsets come from ``jitter`` (``bins.shape[:-1] + (1,)``).  Returns
    ``(edges (..., S + 1), centers (..., S))``."""
    s = num_samples
    if bins.shape[-1] != weights.shape[-1] + 1:
        raise ValueError("bins must have one more edge than weights")
    eps = torch.finfo(weights.dtype).eps
    pdf = weights / weights.abs().sum(-1, keepdim=True).clamp(min=eps)
    cdf = torch.cat(
        [torch.zeros_like(pdf[..., :1]), torch.cumsum(pdf[..., :-1], dim=-1), torch.ones_like(pdf[..., :1])],
        dim=-1,
    )
    if not stratified:
        pad = 1 / (2 * s)
        u = torch.linspace(pad, 1 - pad - eps, s, dtype=bins.dtype, device=bins.device)
        u = u.expand(bins.shape[:-1] + (s,))
    else:
        u_max = eps + (1 - eps) / s
        max_jitter = (1 - u_max) / (s - 1) - eps
        u = torch.linspace(0, 1 - u_max, s, dtype=bins.dtype, device=bins.device) + jitter * max_jitter

    n = cdf.shape[-1]
    ceil = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    floor = (ceil - 1).clamp(0, n - 1)
    ceil = ceil.clamp(0, n - 1)
    cdf0, cdf1 = cdf.gather(-1, floor), cdf.gather(-1, ceil)
    b0, b1 = bins.gather(-1, floor), bins.gather(-1, ceil)
    t = (u - cdf0) / (cdf1 - cdf0).clamp(min=eps)
    centers = b0 + t * (b1 - b0)
    samples = (centers[..., 1:] + centers[..., :-1]) / 2
    samples = torch.cat(
        [
            torch.clamp(2 * centers[..., :1] - samples[..., :1], min=vmin),
            samples,
            torch.clamp(2 * centers[..., -1:] - samples[..., -1:], max=vmax),
        ],
        dim=-1,
    )
    return samples, centers
