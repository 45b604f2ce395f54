"""Multi-level occupancy-grid ray traversal.

Port of ``nerfacc_tpu/grid.py:50-335,338-348,725-924``.  Traversal is the
JAX package's vectorised two-stage form: every ray's marching ladder is
materialised (closed form of ``t_{k+1} = t_k + clamp(t_k * cone, step,
inf)``), each ladder midpoint is tested against the grid, and the valid
samples are compacted to the front of each ray's row.  The occupancy test is
kernel K1 (:func:`~nerfacc_tpu_torch.ops.occ_query.occupancy_query`) on
the bit-packed grid.

The macro-skip branch of ``traverse_grids`` and ``traverse_and_compact``
(``grid.py:381-722``) serve the training path and come with it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .ops.occ_query import occupancy_query

Tensor = torch.Tensor

__all__ = ["ray_aabb_intersect", "traverse_grids", "TraversalResults"]


def ray_aabb_intersect(
    rays_o: Tensor,
    rays_d: Tensor,
    aabbs: Tensor,
    near_plane: float = -float("inf"),
    far_plane: float = float("inf"),
    miss_value: float = float("inf"),
) -> Tuple[Tensor, Tensor, Tensor]:
    """Slab test of each ray against each box: ``(t_mins, t_maxs, hits)``,
    each ``(n_rays, m)``."""
    assert rays_o.ndim == 2 and rays_o.shape[-1] == 3
    assert rays_d.ndim == 2 and rays_d.shape[-1] == 3
    assert aabbs.ndim == 2 and aabbs.shape[-1] == 6
    inv_d = 1.0 / rays_d  # IEEE gives +-inf for 0; min/max handle it
    t1 = (aabbs[None, :, :3] - rays_o[:, None, :]) * inv_d[:, None, :]
    t2 = (aabbs[None, :, 3:] - rays_o[:, None, :]) * inv_d[:, None, :]
    t_mins = torch.minimum(t1, t2).amax(dim=-1)
    t_maxs = torch.maximum(t1, t2).amin(dim=-1)
    hits = (t_maxs > t_mins) & (t_maxs > 0)
    t_mins = t_mins.clamp(min=near_plane, max=far_plane)
    t_maxs = t_maxs.clamp(min=near_plane, max=far_plane)
    t_mins = torch.where(hits, t_mins, miss_value)
    t_maxs = torch.where(hits, t_maxs, miss_value)
    return t_mins, t_maxs, hits


def _enlarge_aabb(aabb: Tensor, factor: float) -> Tensor:
    """Scale an aabb about its center."""
    center = (aabb[:3] + aabb[3:]) / 2
    extent = (aabb[3:] - aabb[:3]) / 2
    return torch.cat([center - extent * factor, center + extent * factor])


def _march_ladder(
    near: Tensor, n_edges: int, step_size: float, cone_angle: float
) -> Tensor:
    """Ladder edge positions, shape ``near.shape + (n_edges,)``."""
    k = torch.arange(n_edges, dtype=near.dtype, device=near.device)
    if cone_angle <= 0.0:
        return near[..., None] + k * step_size
    t_switch = step_size / cone_angle
    k_sw = torch.ceil((t_switch - near).clamp(min=0.0) / step_size)
    t_lin = near[..., None] + k * step_size
    t_at_sw = near + k_sw * step_size
    t_geo = t_at_sw[..., None] * torch.pow(1.0 + cone_angle, k - k_sw[..., None])
    return torch.where(k <= k_sw[..., None], t_lin, t_geo)


def _ladder_at(near: Tensor, k: Tensor, step_size: float, cone_angle: float) -> Tensor:
    """Ladder edge position at integer index ``k``; ``near`` broadcasts
    against ``k``."""
    kf = k.to(near.dtype)
    if cone_angle <= 0.0:
        return near + kf * step_size
    t_switch = step_size / cone_angle
    k_sw = torch.ceil((t_switch - near).clamp(min=0.0) / step_size)
    t_lin = near + kf * step_size
    t_at_sw = near + k_sw * step_size
    t_geo = t_at_sw * torch.pow(1.0 + cone_angle, kf - k_sw)
    return torch.where(kf <= k_sw, t_lin, t_geo)


def num_ladder_steps(
    t_range: float, step_size: float, cone_angle: float, near: float = 0.0
) -> int:
    """Upper bound on ladder steps needed to cover ``t_range`` from ``near``."""
    if cone_angle <= 0.0:
        return max(1, int(math.ceil(t_range / step_size)))
    t_switch = step_size / cone_angle
    far = near + t_range
    n_lin = max(0.0, math.ceil((t_switch - near) / step_size))
    t_at_sw = near + n_lin * step_size
    if far <= t_at_sw:
        return max(1, int(math.ceil(t_range / step_size)))
    n_geo = math.ceil(
        math.log(max(far, 1e-9) / max(t_at_sw, step_size)) / math.log1p(cone_angle)
    )
    return max(1, int(n_lin + max(0.0, n_geo) + 2))


def build_skip_grid(binaries: Tensor, factor: int = 4, dilation: int = 1) -> Tensor:
    """Down-sampled, dilated occupancy for macro-segment skipping.

    ``binaries`` is ``(m, rx, ry, rz)`` bool; returns ``(m, rx/f, ry/f,
    rz/f)`` bool, where a macro cell is occupied iff a fine cell in its
    ``factor``-block, or within ``dilation`` macro cells, is occupied.
    """
    m, rx, ry, rz = binaries.shape
    f = factor
    assert rx % f == 0 and ry % f == 0 and rz % f == 0, (
        f"build_skip_grid: factor {f} must divide resolution "
        f"({rx},{ry},{rz}); pick a common divisor (1 always works)"
    )
    coarse = binaries.reshape(m, rx // f, f, ry // f, f, rz // f, f).any(dim=6)
    coarse = coarse.any(dim=4).any(dim=2)
    if dilation == 0:
        return coarse
    # A (2d+1)^3 max-pool is the JAX package's three per-axis dilations.
    pooled = F.max_pool3d(
        coarse.to(torch.float32), kernel_size=2 * dilation + 1, stride=1,
        padding=dilation,
    )
    return pooled > 0


class TraversalResults(NamedTuple):
    """Dense traversal output, ``(n_rays, capacity)`` rows of samples."""

    t_starts: Tensor  # (n_rays, capacity)
    t_ends: Tensor  # (n_rays, capacity)
    is_valid: Tensor  # (n_rays, capacity) bool
    termination_planes: Tensor  # (n_rays,)
    num_valid: Tensor  # (n_rays,) int32, samples emitted (capped at capacity)
    far_effective: Tensor  # (n_rays,) min(far_plane, outermost-grid exit)


def traverse_grids(
    rays_o: Tensor,
    rays_d: Tensor,
    binaries: Tensor,
    aabbs: Tensor,
    near_planes: Optional[Tensor] = None,
    far_planes: Optional[Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    traverse_steps_limit: Optional[int] = None,
    rays_mask: Optional[Tensor] = None,
    *,
    packed_grids: Tensor,
    max_lattice_steps: int = 1024,
    base_aabb: Optional[Tensor] = None,
) -> TraversalResults:
    """Vectorised multi-level grid traversal (dense ladder).

    Outputs have the capacity ``traverse_steps_limit`` (default
    ``max_lattice_steps``) per ray with ``is_valid`` masking; invalid slots
    carry ``t_start == t_end == termination plane``, exact no-ops in the
    density rendering path.  ``packed_grids`` is ``binaries`` packed by
    :func:`~nerfacc_tpu_torch.ops.occ_query.bitpack_grid` (an
    ``OccGridState`` keeps it as ``binaries_packed``); the occupancy test is
    kernel K1 on it.
    """
    n_rays = rays_o.shape[0]
    dtype, device = rays_o.dtype, rays_o.device
    capacity = traverse_steps_limit or max_lattice_steps
    if near_planes is None:
        near_planes = torch.zeros((n_rays,), dtype=dtype, device=device)
    if far_planes is None:
        far_planes = torch.full((n_rays,), math.inf, dtype=dtype, device=device)
    if base_aabb is None:
        base_aabb = aabbs[0]

    # Clamp the march window to the outermost grid's extent.
    t_mins, t_maxs, hits = ray_aabb_intersect(rays_o, rays_d, aabbs)
    t_enter = torch.where(hits, t_mins, math.inf).amin(dim=-1)
    t_exit = torch.where(hits, t_maxs, -math.inf).amax(dim=-1)
    any_hit = hits.any(dim=-1)

    near = near_planes.clamp(min=0.0)
    far = torch.minimum(far_planes, torch.where(any_hit, t_exit, near_planes))
    if rays_mask is not None:
        any_hit = any_hit & rays_mask
    lower = torch.maximum(near, t_enter)

    # Stage 1: the full ladder, per-axis sample positions.
    edges = _march_ladder(near, max_lattice_steps + 1, step_size, cone_angle)
    t0 = edges[:, :-1]
    t1 = edges[:, 1:]
    t_mid = (t0 + t1) * 0.5
    lattice_end = edges[:, -1]
    px = rays_o[:, 0:1] + t_mid * rays_d[:, 0:1]
    py = rays_o[:, 1:2] + t_mid * rays_d[:, 1:2]
    pz = rays_o[:, 2:3] + t_mid * rays_d[:, 2:3]
    occ = occupancy_query(
        packed_grids, base_aabb.contiguous(), px, py, pz, rz=int(binaries.shape[-1])
    )

    inside = (t_mid >= lower[:, None]) & (t_mid < far[:, None])
    valid = occ & inside & any_hit[:, None]

    # Stage 2: per-row compaction; invalid samples go to a spare column.
    vcum = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    slot = torch.where(valid & (vcum <= capacity), vcum - 1, capacity).long()
    zeros = torch.zeros((n_rays, capacity + 1), dtype=dtype, device=device)
    t_starts = zeros.scatter(1, slot, t0)[:, :capacity]
    t_ends = zeros.scatter(1, slot, t1)[:, :capacity]

    count = vcum[:, -1]
    num_valid = count.clamp(max=capacity)
    slots = torch.arange(capacity, dtype=torch.int32, device=device)
    is_valid = slots < num_valid[:, None]

    # Termination plane: the end of the last emitted sample when the
    # capacity was hit, else how far the (windowed) lattice examined.
    hit_cap = count >= capacity
    last_end = t_ends.amax(dim=-1)
    examined = torch.minimum(lattice_end, far)
    term = torch.where(hit_cap, last_end, torch.maximum(examined, near))

    t_starts = torch.where(is_valid, t_starts, term[:, None])
    t_ends = torch.where(is_valid, t_ends, term[:, None])
    return TraversalResults(
        t_starts=t_starts,
        t_ends=t_ends,
        is_valid=is_valid,
        termination_planes=term,
        num_valid=num_valid,
        far_effective=far,
    )
