"""Plain occupancy grid: nerfacc's EMA update and its ray marching with
empty-space skipping, under the budgets the configuration states.

The update (nerfacc ``OccGridEstimator._update``): every cell during
warm-up, else a quarter of the cells uniformly and a quarter from the
occupied cells (rows of 128 of the ascending occupied list, at a fixed
stride from one random offset); each probe at its cell's corner plus a
jitter, ``occ = density * step``; ``occs = max(0.95 occs, max of the
probes)``; occupied where ``occs > min(mean occs, 0.01)``.

The march: a ray's ladder ``t_k = near + k * step`` over ``lattice`` steps
(the outer box's diagonal over the step), a sample ``[t_k, t_{k+1}]`` kept
where its midpoint lies in ``[max(near, box entry), box exit)`` and in an
occupied cell.  The ladder is cut into segments of ``stride`` steps; a
segment counts where its midpoint lies in an occupied cell of the skip grid
(the grid OR-reduced over 2x2x2 blocks, then dilated by one block), and
only a ray's first ``max_segments`` counted segments are marched (ladder
indices past the lattice end read as the last).  The kept samples of all
rays, in ray order and then ladder order, fill ``capacity`` slots; the rest
are dropped (one slot a sample: with a macro stride that is a multiple of
4 the program fills its slots in chunks of 4 ladder steps, which this
reference does not model, and :func:`march` refuses such a stride).  A
point's cell on a grid of ``r`` cells over ``[lo, hi]`` is
``trunc(r * (c + 0.5))`` for ``c = (p - lo) / (hi - lo) - 0.5``, and the
point is in the box where ``|c| < 0.5`` on every axis.

The visibility filter (nerfacc ``OccGridEstimator.sampling`` with a
``sigma_fn``): a sample is kept where the transmittance before it,
``exp(-sum of sigma dt over the ray's earlier samples)``, is at least
``early_stop_eps`` and its alpha at least ``min(mean occs, alpha_thre)``;
the first ``capacity`` survivors, in ray order, fill the slots of the
differentiable pass.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def cell_index(p: Tensor, lo: Tensor, hi: Tensor, res: int):
    """``(flat cell index, inside)`` of points ``p`` ``(..., 3)``."""
    c = (p - lo) / (hi - lo) - 0.5
    inside = c.abs().amax(dim=-1) < 0.5
    ijk = ((c + 0.5) * res).to(torch.int64).clamp(0, res - 1)
    return (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2], inside


def occupied(grid: Tensor, p: Tensor, lo: Tensor, hi: Tensor) -> Tensor:
    res = grid.shape[-1]
    idx, inside = cell_index(p, lo, hi, res)
    return grid.reshape(-1)[idx] & inside


def skip_grid(binaries: Tensor) -> Tensor:
    """``(r/2)^3`` blocks, occupied where a cell of the block or of a block
    next to it (26-neighbourhood) is occupied."""
    r = binaries.shape[-1]
    coarse = binaries.reshape(r // 2, 2, r // 2, 2, r // 2, 2).any(dim=5).any(dim=3).any(dim=1)
    return F.max_pool3d(coarse[None].float(), kernel_size=3, stride=1, padding=1)[0] > 0


def update(occs: Tensor, binaries: Tensor, density_fn: Callable, aabb: Tensor, res: int, step_size: float,
           warmup: bool, draws: dict, ema_decay: float = 0.95, occ_thre: float = 0.01):
    """One EMA update of a one-level grid; ``draws`` as the benchmark makes
    them (``jitter``, and after warm-up ``uniform`` and ``offset``).
    Returns ``(occs, binaries)``."""
    cells = res**3
    device = occs.device
    if warmup:
        idx = torch.arange(cells, device=device)
    else:
        n = cells // 4
        order = torch.argsort(torch.where(binaries.reshape(-1), 0, 1), stable=True)
        total = int(binaries.sum())
        if total == 0:
            picked = draws["uniform"]
        else:
            rows = n // 128
            total_rows = max(1, -(-total // 128))
            scale = torch.tensor(float(total_rows), device=device) / rows
            q = ((torch.arange(rows, dtype=torch.float32, device=device) + draws["offset"]) * scale).to(torch.int64)
            q = q.clamp(max=total_rows - 1)
            picked = order.view(-1, 128)[q].reshape(-1)
        idx = torch.cat([draws["uniform"], picked])
    ijk = torch.stack([idx // (res * res), (idx // res) % res, idx % res], dim=-1).float()
    x = (ijk + draws["jitter"]) / res
    x = aabb[:3] + x * (aabb[3:] - aabb[:3])
    occ = density_fn(x) * step_size
    proposed = torch.full((cells,), -1.0, device=device).scatter_reduce(0, idx, occ, reduce="amax")
    touched = proposed >= 0.0
    occs = torch.where(touched, torch.maximum(occs * ema_decay, proposed.clamp(min=0.0)), occs)
    thre = occs.mean().clamp(max=occ_thre)
    return occs, (occs > thre).reshape(1, res, res, res)


def march(o: Tensor, d: Tensor, near: Tensor, binaries: Tensor, aabb: Tensor, step: float, lattice: int,
          stride: int, max_segments: int, capacity: int, far_plane: float = 1e10):
    """The kept samples of rays ``o, d`` ``(n, 3)`` from per-ray ``near``
    planes: ``(ray index, t_start, t_end)``, each ``(m,)`` with ``m <=
    capacity``, ray-major."""
    if stride % 4 == 0:
        raise ValueError(f"macro stride {stride}: slots filled in chunks of 4 are not modelled")
    lo, hi = aabb[:3], aabb[3:]
    inv = 1.0 / d
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    tmin = torch.minimum(t1, t2).amax(dim=-1)
    tmax = torch.maximum(t1, t2).amin(dim=-1)
    hit = (tmax > tmin) & (tmax > 0)
    near = near.clamp(min=0.0)
    far = torch.minimum(torch.full_like(near, far_plane), torch.where(hit, tmax, near))
    lower = torch.maximum(near, torch.where(hit, tmin, torch.inf))

    def t_at(k: Tensor) -> Tensor:
        return near[:, None] + k.to(near.dtype) * step

    skip = skip_grid(binaries[0])
    n_seg = -(-lattice // stride)
    seg_k = torch.arange(n_seg, device=o.device) * stride
    seg_lo, seg_hi = t_at(seg_k[None]), t_at(seg_k[None] + stride)
    t_probe = seg_lo + (seg_hi - seg_lo) * 0.5
    seg_ok = occupied(skip, o[:, None] + t_probe[..., None] * d[:, None], lo, hi)
    seg_ok = seg_ok & (seg_hi > lower[:, None]) & (seg_lo < far[:, None]) & hit[:, None]
    seg_ok = seg_ok & (torch.cumsum(seg_ok.int(), dim=-1) <= max_segments)

    k = (seg_k[:, None] + torch.arange(stride, device=o.device)[None]).reshape(-1).clamp(max=lattice)
    t0, t1_ = t_at(k[None]), t_at(k[None] + 1)
    mid = (t0 + t1_) * 0.5
    ok = occupied(binaries[0], o[:, None] + mid[..., None] * d[:, None], lo, hi)
    ok = ok & (mid >= lower[:, None]) & (mid < far[:, None]) & hit[:, None]
    ok = ok & seg_ok.repeat_interleave(stride, dim=-1)
    ray, col = torch.nonzero(ok, as_tuple=True)  # row-major: ray order, then ladder order
    ray, col = ray[:capacity], col[:capacity]
    return ray, t0[ray, col], t1_[ray, col]


def visible(ray: Tensor, t0: Tensor, t1: Tensor, sigma: Tensor, n_rays: int, alpha_thre: float,
            capacity: int, early_stop_eps: float = 1e-4) -> Tensor:
    """Indices of the samples (listed ray-major) that the visibility filter
    keeps, the first ``capacity`` of them."""
    sdt = sigma * (t1 - t0)
    counts = torch.bincount(ray, minlength=n_rays)
    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(ray.shape[0], device=ray.device) - starts[ray]
    width = int(counts.max()) if ray.numel() else 1
    dense = torch.zeros((n_rays, width), dtype=sdt.dtype, device=sdt.device).index_put((ray, col), sdt)
    before = (torch.cumsum(dense, dim=-1) - dense)[ray, col]
    keep = (torch.exp(-before) >= early_stop_eps) & (1.0 - torch.exp(-sdt) >= alpha_thre)
    return torch.nonzero(keep, as_tuple=True)[0][:capacity]
