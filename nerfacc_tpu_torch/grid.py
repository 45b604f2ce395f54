"""Multi-level occupancy-grid ray traversal.

Port of ``nerfacc_tpu/grid.py:50-722,725-924``.  Traversal is the JAX
package's vectorised two-stage form: every ray's marching ladder is
materialised (closed form of ``t_{k+1} = t_k + clamp(t_k * cone, step,
inf)``), each ladder midpoint is tested against the grid, and the valid
samples are compacted.  The occupancy test is kernel K1
(:func:`~nerfacc_tpu_torch.ops.occ_query.occupancy_query`) on the
bit-packed grid, and so are the macro-skip probes of both traversals (on
the packed skip grid, ``mip_pad=1``).

:func:`traverse_grids` compacts each ray's row (the inference renderer);
:func:`traverse_and_compact` compacts straight into one flat, globally
sorted buffer of fixed capacity (the training path).  Both take the
macro-skip branch when given a skip grid (:func:`_macro_lattice`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops.occ_query import occupancy_query

Tensor = torch.Tensor

__all__ = [
    "ray_aabb_intersect",
    "traverse_grids",
    "traverse_and_compact",
    "TraversalResults",
    "CompactSamples",
]


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


def _geometric(t_at_sw: Tensor, steps: Tensor, cone_angle: float) -> Tensor:
    """``t_at_sw * (1 + cone_angle) ** steps``, the geometric ladder.  The
    power is taken in float64 and rounded to ``t_at_sw``'s dtype: in float32,
    CUDA's ``pow`` and the CPU's differ in the last bit of about one value
    in fifteen, and the two devices would then march other samples, while
    both round the float64 power to the same float32.  The base is ``1 +
    cone_angle`` in float32 and the product is taken in float32, as the JAX
    package takes them."""
    base = float(np.float32(1.0 + cone_angle))
    return t_at_sw * torch.pow(base, steps.double()).to(t_at_sw.dtype)


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
    t_geo = _geometric(t_at_sw[..., None], k - k_sw[..., None], cone_angle)
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
    t_geo = _geometric(t_at_sw, kf - k_sw, cone_angle)
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


def _macro_lattice(
    rays_o: Tensor, rays_d: Tensor, near: Tensor, lower: Tensor, far: Tensor, any_hit: Tensor,
    skip_grid: Tensor, packed_skip: Optional[Tensor], base_aabb: Tensor, step_size: float,
    cone_angle: float, max_lattice_steps: int, macro_stride: int, max_macro_segments: int,
):
    """The macro-skip stage (``grid.py:785-865``): the lattice is cut into
    segments of ``macro_stride`` steps, each segment probed on the skip grid
    (kernel K1 on ``packed_skip``, ``mip_pad=1``; one probe at its middle,
    four with ``cone_angle > 0``, where segment spans and mip cells both grow
    ~ t), and the first ``max_macro_segments`` occupied segments of each ray
    kept.  Returns the lattice steps ``(n_rays, K * macro_stride)`` int32,
    their liveness, the rays whose occupied segments passed the budget, and
    where those rays' examined span ends (inf for the others)."""
    if packed_skip is None:
        raise ValueError("macro-skip traversal: skip_grid needs its packed copy packed_skip")
    n_rays, device = rays_o.shape[0], rays_o.device
    m_segs = -(-max_lattice_steps // macro_stride)
    k_keep = max_macro_segments
    seg_k = torch.arange(m_segs, dtype=torch.int32, device=device) * macro_stride
    seg_lo = _ladder_at(near[:, None], seg_k, step_size, cone_angle)
    seg_hi = _ladder_at(near[:, None], seg_k + macro_stride, step_size, cone_angle)
    offsets = (0.5,) if cone_angle <= 0.0 else (0.125, 0.375, 0.625, 0.875)
    tm = torch.stack([seg_lo + (seg_hi - seg_lo) * off for off in offsets], dim=-1)
    probes = [
        (rays_o[:, i, None, None] + tm * rays_d[:, i, None, None]).contiguous()
        for i in range(3)
    ]
    mocc = occupancy_query(
        packed_skip, base_aabb, *probes, rz=int(skip_grid.shape[-1]), mip_pad=1
    ).any(dim=-1)
    macro_valid = (
        mocc & (seg_hi > lower[:, None]) & (seg_lo < far[:, None]) & any_hit[:, None]
    )
    mcum = torch.cumsum(macro_valid.to(torch.int32), dim=-1, dtype=torch.int32)
    # First-K selection: the k-th (0-based) occupied segment sits at the
    # number of columns whose running count is below k + 1; rays with fewer
    # segments count to m_segs, the dead-segment sentinel.
    kr = torch.arange(1, k_keep + 1, dtype=torch.int32, device=device)
    seg_idx = (mcum[:, :, None] < kr).sum(dim=1, dtype=torch.int32)  # (n_rays, K)
    seg_live = seg_idx < m_segs
    seg_idx = seg_idx.clamp(max=m_segs - 1)
    macro_truncated = mcum[:, -1] > k_keep
    last_seg = torch.where(seg_live, seg_idx, 0).amax(dim=-1)
    macro_end = _ladder_at(near, (last_seg + 1) * macro_stride, step_size, cone_angle)
    examined_end = torch.where(macro_truncated, macro_end, math.inf)

    steps = torch.arange(macro_stride, dtype=torch.int32, device=device)
    lat = (seg_idx[:, :, None] * macro_stride + steps).reshape(n_rays, k_keep * macro_stride)
    lat = lat.clamp(max=max_lattice_steps)
    live = seg_live.repeat_interleave(macro_stride, dim=-1)
    return lat, live, macro_truncated, examined_end


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
    skip_grid: Optional[Tensor] = None,
    skip_factor: Optional[int] = None,
    macro_stride: int = 16,
    max_macro_segments: int = 16,
    packed_skip: Optional[Tensor] = None,
) -> TraversalResults:
    """Vectorised multi-level grid traversal.

    Outputs have the capacity ``traverse_steps_limit`` (default
    ``max_lattice_steps``) per ray with ``is_valid`` masking; invalid slots
    carry ``t_start == t_end == termination plane``, exact no-ops in the
    density rendering path.  ``packed_grids`` is ``binaries`` packed by
    :func:`~nerfacc_tpu_torch.ops.occ_query.bitpack_grid` (an
    ``OccGridState`` keeps it as ``binaries_packed``); the occupancy test is
    kernel K1 on it.

    With ``skip_grid`` (and its packed copy ``packed_skip``; an
    ``OccGridState`` keeps them as ``skip_grid`` and ``skip_packed``) only
    the first ``max_macro_segments`` occupied macro segments of
    ``macro_stride`` steps are marched (:func:`_macro_lattice`,
    ``grid.py:785-865``); a ray whose occupied segments pass that budget
    ends its examined span at the last kept segment.  The skip grid's shape
    fixes its factor; a ``skip_factor`` given beside it must agree.
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
    base_aabb = base_aabb.contiguous()
    if skip_grid is not None and skip_factor is not None:
        if skip_grid.shape[-1] * skip_factor != binaries.shape[-1]:
            raise ValueError(
                f"traverse_grids: skip_factor {skip_factor} disagrees with the skip grid "
                f"{tuple(skip_grid.shape)} of the grid {tuple(binaries.shape)}"
            )

    # Stage 1: the ladder (the kept macro segments', or all of it), per-axis
    # sample positions.
    examined_end = live = None
    if skip_grid is not None:
        lat, live, _, examined_end = _macro_lattice(
            rays_o, rays_d, near, lower, far, any_hit, skip_grid, packed_skip, base_aabb,
            step_size, cone_angle, max_lattice_steps, macro_stride, max_macro_segments,
        )
        t0 = _ladder_at(near[:, None], lat, step_size, cone_angle)
        t1 = _ladder_at(near[:, None], lat + 1, step_size, cone_angle)
        lattice_end = _ladder_at(
            near, torch.full((n_rays,), max_lattice_steps, dtype=torch.int32, device=device),
            step_size, cone_angle,
        )
    else:
        edges = _march_ladder(near, max_lattice_steps + 1, step_size, cone_angle)
        t0 = edges[:, :-1]
        t1 = edges[:, 1:]
        lattice_end = edges[:, -1]
    t_mid = (t0 + t1) * 0.5
    px = (rays_o[:, 0:1] + t_mid * rays_d[:, 0:1]).contiguous()
    py = (rays_o[:, 1:2] + t_mid * rays_d[:, 1:2]).contiguous()
    pz = (rays_o[:, 2:3] + t_mid * rays_d[:, 2:3]).contiguous()
    occ = occupancy_query(packed_grids, base_aabb, px, py, pz, rz=int(binaries.shape[-1]))

    inside = (t_mid >= lower[:, None]) & (t_mid < far[:, None])
    valid = occ & inside & any_hit[:, None]
    if live is not None:
        valid = valid & live

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
    if examined_end is not None:
        examined = torch.minimum(examined, examined_end)
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


class CompactSamples(NamedTuple):
    """Flat compacted samples straight from the traversal lattice.

    ``ray_indices`` is sorted ascending (capacity padding decodes to the last
    ray with ``kept`` False), and ``seg_starts``/``seg_counts`` give each
    ray's chunk-aligned slot range, so per-ray sums can be taken as a
    cumulative sum and two boundary gathers
    (``volrend.rendering(seg_bounds=...)``).
    """

    ray_indices: Tensor  # (capacity,) int32, sorted ascending
    t_starts: Tensor  # (capacity,)
    t_ends: Tensor  # (capacity,)
    kept: Tensor  # (capacity,) bool
    num_valid: Tensor  # (n_rays,) int32
    termination_planes: Tensor  # (n_rays,)
    far_effective: Tensor  # (n_rays,)
    seg_starts: Tensor  # (n_rays,) int32, first slot of each ray's samples
    seg_counts: Tensor  # (n_rays,) int32, slots spanned (chunk-aligned)
    # Rays that crossed more occupied macro segments than the budget
    # ``max_macro_segments``: their tail samples were dropped.  Always False
    # without macro-skip.
    macro_truncated: Tensor  # (n_rays,) bool
    # With ``carry_rays``: each slot's ray origin and direction components,
    # ``((ox, oy, oz), (dx, dy, dz))``, 1-D ``(capacity,)``; else None.
    ray_comps: Optional[Tuple] = None


def traverse_and_compact(
    rays_o: Tensor,
    rays_d: Tensor,
    binaries: Tensor,
    aabbs: Tensor,
    capacity: int,
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
    skip_grid: Optional[Tensor] = None,
    packed_skip: Optional[Tensor] = None,
    macro_stride: int = 16,
    max_macro_segments: int = 16,
    compact_chunk: int = 4,
    carry_rays: bool = False,
) -> CompactSamples:
    """Traversal fused with global compaction into ``capacity`` slots.

    Port of ``nerfacc_tpu/grid.py:381-722``.  With ``skip_grid`` (and its
    packed copy ``packed_skip``) only the first ``max_macro_segments``
    occupied macro segments of ``macro_stride`` steps per ray are traversed
    (:func:`_macro_lattice`).

    ``carry_rays`` adds ``ray_comps``: each slot's ray origin and direction
    components, ``rays_o[ray_indices, k]`` and ``rays_d[ray_indices, k]``,
    padding slots included (they decode to ray ``n_rays - 1``).  The JAX
    package carries them through its compaction sort; a gather after the
    compaction gives the same floats.

    Compaction works on chunks of ``C = compact_chunk`` lattice steps: each
    chunk holding an in-budget sample gets one packed int64 ``[row |
    lattice step | C valid bits]`` in its output slot (a scatter with unique
    slots), and the slots expand back to samples by arithmetic; a chunk's
    invalid samples come out as ``kept=False`` zero-length intervals.  ``C``
    falls back to 1 where chunks would straddle a macro segment or the
    shapes are not multiples of ``C``, by the JAX package's rule, so both
    give the same layout.
    """
    n_rays = rays_o.shape[0]
    dtype, device = rays_o.dtype, rays_o.device
    row_limit = traverse_steps_limit or max_lattice_steps
    if near_planes is None:
        near_planes = torch.zeros((n_rays,), dtype=dtype, device=device)
    if far_planes is None:
        far_planes = torch.full((n_rays,), math.inf, dtype=dtype, device=device)
    if base_aabb is None:
        base_aabb = aabbs[0]
    base_aabb = base_aabb.contiguous()

    t_mins, t_maxs, hits = ray_aabb_intersect(rays_o, rays_d, aabbs)
    t_enter = torch.where(hits, t_mins, math.inf).amin(dim=-1)
    t_exit = torch.where(hits, t_maxs, -math.inf).amax(dim=-1)
    any_hit = hits.any(dim=-1)
    near = near_planes.clamp(min=0.0)
    far = torch.minimum(far_planes, torch.where(any_hit, t_exit, near_planes))
    if rays_mask is not None:
        any_hit = any_hit & rays_mask
    lower = torch.maximum(near, t_enter)

    def ladder(k: Tensor, nr: Tensor = near[:, None]) -> Tensor:
        return _ladder_at(nr, k, step_size, cone_angle)

    examined_end = None
    if skip_grid is not None:
        lat, live, macro_truncated, examined_end = _macro_lattice(
            rays_o, rays_d, near, lower, far, any_hit, skip_grid, packed_skip, base_aabb,
            step_size, cone_angle, max_lattice_steps, macro_stride, max_macro_segments,
        )
    else:
        lat = torch.arange(max_lattice_steps, dtype=torch.int32, device=device)
        lat = lat.expand(n_rays, max_lattice_steps)
        live = None
        macro_truncated = torch.zeros((n_rays,), dtype=torch.bool, device=device)
    t_mid = (ladder(lat) + ladder(lat + 1)) * 0.5
    lattice_end = ladder(
        torch.full((n_rays,), max_lattice_steps, dtype=torch.int32, device=device), near
    )

    px, py, pz = (
        (rays_o[:, i : i + 1] + t_mid * rays_d[:, i : i + 1]).contiguous() for i in range(3)
    )
    occ = occupancy_query(packed_grids, base_aabb, px, py, pz, rz=int(binaries.shape[-1]))
    valid = occ & (t_mid >= lower[:, None]) & (t_mid < far[:, None]) & any_hit[:, None]
    if live is not None:
        valid = valid & live
    vcum = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    counts = vcum[:, -1].clamp(max=row_limit)

    C = compact_chunk
    width = lat.shape[1]
    bits_p = max(1, int(max_lattice_steps + 1).bit_length())
    # The JAX package packs into int32 and needs the headroom; the port packs
    # into int64 but keeps the rule, so that both choose the same C.
    if (
        width % C != 0
        or capacity % C != 0
        or (skip_grid is not None and macro_stride % C)
        or n_rays >= (1 << (31 - bits_p - C))
    ):
        C = 1
    assert n_rays < (1 << (31 - bits_p - C)), "too many rays for packed compaction"
    nch = width // C
    cap_c = capacity // C
    in_budget = valid & (vcum <= row_limit)
    ib = in_budget.reshape(n_rays, nch, C)
    cvalid = ib.any(dim=-1)
    ccum = torch.cumsum(cvalid.to(torch.int32), dim=-1, dtype=torch.int32)
    ccounts = ccum[:, -1]
    ccum0 = torch.cumsum(ccounts, dim=0, dtype=torch.int32) - ccounts
    ctotal = ccum0[-1] + ccounts[-1]
    # Invalid chunks get distinct slots past the output (dropped), so every
    # slot index is unique; valid chunks beyond the capacity land there too.
    flat_pos = torch.arange(n_rays * nch, device=device).view(n_rays, nch)
    slot = torch.where(cvalid, (ccum0[:, None] + ccum - 1).long(), cap_c + flat_pos)
    chunk_bits = torch.arange(C, device=device)
    vbits = (ib.long() << chunk_bits).sum(dim=-1)
    base_lat = lat.reshape(n_rays, nch, C)[:, :, 0].long()
    rows = torch.arange(n_rays, device=device)[:, None]
    packed = (rows << (bits_p + C)) | (base_lat << C) | vbits
    # Padding decodes to (last ray, clamped lattice end, no valid bits):
    # kept False, t_start == t_end, and ray_indices stays sorted.
    fill = ((n_rays - 1) << (bits_p + C)) | (max_lattice_steps << C)
    inv = torch.full((cap_c + n_rays * nch,), fill, dtype=torch.int64, device=device)
    inv = inv.scatter_(0, slot.reshape(-1), packed.reshape(-1))[:cap_c]

    r = (inv >> (bits_p + C)).repeat_interleave(C)
    base = ((inv >> C) & ((1 << bits_p) - 1)).repeat_interleave(C)
    vb = (inv & ((1 << C) - 1)).repeat_interleave(C)
    off = chunk_bits.repeat(cap_c)
    p = (base + off).clamp(max=max_lattice_steps)
    live_c = torch.arange(cap_c, device=device) < ctotal
    kept = live_c.repeat_interleave(C) & (((vb >> off) & 1) == 1)
    # The JAX package carries each chunk's near plane through its sort; a
    # gather by row gives the same floats.
    near_r = near[r]
    t_starts = _ladder_at(near_r, p, step_size, cone_angle)
    t_ends = _ladder_at(near_r, p + 1, step_size, cone_angle)
    t_ends = torch.where(kept, t_ends, t_starts)

    # Termination planes, as in traverse_grids: the end of the last kept
    # sample when the row budget was hit, else how far the lattice looked.
    hit_cap = vcum[:, -1] >= row_limit
    last_col = torch.argmax(torch.where(in_budget, vcum, -1), dim=-1)
    last_p = lat.gather(1, last_col[:, None])[:, 0]
    last_end = _ladder_at(near, last_p + 1, step_size, cone_angle)
    examined = torch.minimum(lattice_end, far)
    if examined_end is not None:
        examined = torch.minimum(examined, examined_end)
    term = torch.where(hit_cap, last_end, torch.maximum(examined, near))

    # Per-ray slot ranges in sample units, clamped where chunks overflowed.
    seg_lo_c = ccum0.clamp(max=cap_c)
    seg_hi_c = (ccum0 + ccounts).clamp(max=cap_c)
    return CompactSamples(
        ray_indices=r.to(torch.int32),
        t_starts=t_starts,
        t_ends=t_ends,
        kept=kept,
        num_valid=counts,
        termination_planes=term,
        far_effective=far,
        seg_starts=seg_lo_c * C,
        seg_counts=(seg_hi_c - seg_lo_c) * C,
        macro_truncated=macro_truncated,
        ray_comps=chunked_ray_components(rays_o, rays_d, r, C) if carry_rays else None,
    )



def chunked_ray_components(
    rays_o: Tensor, rays_d: Tensor, ray_indices: Tensor, chunk: int = 4
) -> Tuple[Tuple[Tensor, Tensor, Tensor], Tuple[Tensor, Tensor, Tensor]]:
    """Each sample's ray origin and direction components,
    ``((ox, oy, oz), (dx, dy, dz))``, 1-D ``(n,)`` tensors
    (``rendering.py:56-98``), for a layout in which every aligned run of
    ``chunk`` samples shares one ray, as :func:`traverse_and_compact`'s
    does: one gather a chunk, broadcast along it.  ``chunk=1`` gathers each
    sample's own ray, and so does ``n % chunk != 0``."""
    n = ray_indices.shape[0]
    ri = ray_indices.long()
    if n % chunk:
        chunk = 1
    r_c = ri.view(-1, chunk)[:, 0]

    def comp(col: Tensor) -> Tensor:
        return col[r_c][:, None].expand(n // chunk, chunk).reshape(n)

    return (
        tuple(comp(rays_o[:, k]) for k in range(3)),
        tuple(comp(rays_d[:, k]) for k in range(3)),
    )
