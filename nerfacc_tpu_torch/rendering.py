"""Occupancy-grid renderers: the training renderer and the inference
renderer.

Port of ``nerfacc_tpu/rendering.py:38-53,101-278,281-416``.

:func:`occgrid_render_rays` is the training path: one fused traversal and
compaction into a fixed sample capacity
(:func:`~nerfacc_tpu_torch.grid.traverse_and_compact`), the field on the
flat samples, and differentiable volume rendering with the sorted
``seg_bounds`` accumulation.

:func:`occgrid_render_rays_test` is the iterative alive-ray
renderer (Instant-NGP style).  Each round traverses a bounded window of
``samples_per_round`` samples per alive ray, compacts the valid samples,
queries the field on them, and accumulates colour, opacity and depth with
the transmittance carried over from earlier rounds.  A ray stops when its
opacity passes ``1 - early_stop_eps`` or its termination plane reaches the
far plane, and the loop stops after ``max_samples`` per ray.

Eager PyTorch has dynamic shapes, so each round's compaction capacity is
``n_alive * samples_per_round`` rather than one of the JAX package's fixed
capacity buckets.  The result does not depend on it: no round can hold more
valid samples than that.

Each stage of a round runs inside a ``torch.profiler.record_function``
range, so a profile attributes device time to the stage.  Without a running
profiler a range costs a few microseconds of host time per round.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch.profiler import record_function

from .estimators.occ_grid import OccGridEstimator, OccGridState
from .grid import num_ladder_steps, traverse_grids
from .pack import compact_indices_from_counts
from .volrend import accumulate_along_rays, render_weight_from_density, rendering

Tensor = torch.Tensor


def gather_ray_od(
    rays_o: Tensor, rays_d: Tensor, ray_indices: Tensor
) -> Tuple[Tensor, Tensor]:
    """Per-sample ``(origins, directions)`` through one ``(n, 6)`` row
    gather."""
    g = torch.cat([rays_o, rays_d], dim=-1)[ray_indices.long()]
    return g[:, :3], g[:, 3:]


def occgrid_render_rays(
    rgb_sigma_fn: Callable,  # (t_starts, t_ends, ray_indices) -> (rgb, sigma)
    sigma_fn: Optional[Callable],
    estimator: OccGridEstimator,
    state: OccGridState,
    rays_o: Tensor,
    rays_d: Tensor,
    *,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 1e-3,
    render_bkgd: Optional[Tensor] = None,
    cone_angle: float = 0.0,
    alpha_thre: float = 0.0,
    stratified: bool = False,
    jitter: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    max_samples_per_ray: Optional[int] = None,
    sample_capacity: Optional[int] = None,
    max_macro_segments: int = 24,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, dict]:
    """Render a ray batch for training (``rendering.py:101-278``).

    Returns ``(colors (n,3), opacities (n,1), depths (n,1),
    n_rendering_samples, extras)``, differentiable in the field's
    parameters; ``extras`` adds ``kept``, ``ray_indices`` and
    ``macro_truncated_frac`` to :func:`~nerfacc_tpu_torch.volrend.rendering`'s.
    With ``stratified``, each ray's near plane moves by ``jitter *
    render_step_size`` (``jitter`` an ``(n_rays,)`` tensor in ``[0, 1)``, or
    drawn from ``generator``).  As in the JAX package, ``sigma_fn`` is only
    used for the visibility filter at ``alpha_thre > 0``, which is not
    ported yet (nor is ``refilter_capacity``).
    """
    if alpha_thre > 0.0 and sigma_fn is not None:
        raise NotImplementedError(
            "occgrid_render_rays: the alpha_thre > 0 visibility filter is not ported yet"
        )
    n_rays = rays_o.shape[0]
    with record_function("traverse_and_compact"):
        cs = estimator.compact_samples(
            state, rays_o, rays_d, near_plane=near_plane, far_plane=far_plane,
            render_step_size=render_step_size, stratified=stratified,
            cone_angle=cone_angle, jitter=jitter, generator=generator,
            max_samples=max_samples_per_ray, sample_capacity=sample_capacity,
            max_macro_segments=max_macro_segments,
        )
    # The field runs in its own range, before rendering, so that a profile
    # tells the two apart.
    with record_function("field_forward"):
        field_out = rgb_sigma_fn(cs.t_starts, cs.t_ends, cs.ray_indices)
    with record_function("rendering"):
        colors, opacities, depths, extras = rendering(
            cs.t_starts,
            cs.t_ends,
            ray_indices=cs.ray_indices,
            n_rays=n_rays,
            rgb_sigma_fn=lambda *_: field_out,
            render_bkgd=render_bkgd,
            is_valid=cs.kept,
            seg_bounds=(cs.seg_starts, cs.seg_counts),
        )
    extras = dict(extras)
    extras["kept"] = cs.kept
    extras["ray_indices"] = cs.ray_indices
    extras["macro_truncated_frac"] = cs.macro_truncated.float().mean()
    return colors, opacities, depths, cs.kept.sum(), extras


@torch.no_grad()
def occgrid_render_rays_test(
    rgb_sigma_fn_builder: Callable,  # (rays_o, rays_d) -> fn(t_starts, t_ends, ray_indices)
    estimator: OccGridEstimator,
    state: OccGridState,
    rays_o: Tensor,
    rays_d: Tensor,
    *,
    max_samples: int = 1024,
    samples_per_round: int = 32,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 1e-3,
    render_bkgd: Optional[Tensor] = None,
    cone_angle: float = 0.0,
    alpha_thre: float = 0.0,
    early_stop_eps: float = 1e-4,
) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Render ``rays_o/rays_d (n, 3)`` on their device.

    Returns ``(rgb (n,3), opacity (n,1), depth (n,1), total_samples)``.
    """
    n_rays = rays_o.shape[0]
    dtype, device = rays_o.dtype, rays_o.device

    full_lattice = num_ladder_steps(
        estimator.max_t_range, render_step_size, cone_angle, near=near_plane
    )
    window = min(full_lattice, samples_per_round * 8)
    rgb_sigma_fn = rgb_sigma_fn_builder(rays_o, rays_d)

    near_planes = torch.full((n_rays,), near_plane, dtype=dtype, device=device)
    far_planes = torch.full((n_rays,), far_plane, dtype=dtype, device=device)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=device)
    rgb = torch.zeros((n_rays, 3), dtype=dtype, device=device)
    opacity = torch.zeros((n_rays, 1), dtype=dtype, device=device)
    depth = torch.zeros((n_rays, 1), dtype=dtype, device=device)
    total_samples = torch.zeros((), dtype=torch.int64, device=device)

    n_slots = n_rays * samples_per_round
    iter_samples = 0
    while iter_samples < max_samples:
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        with record_function("traverse_grids"):
            res = traverse_grids(
                rays_o,
                rays_d,
                state.binaries,
                state.aabbs,
                near_planes=near_planes,
                far_planes=far_planes,
                step_size=render_step_size,
                cone_angle=cone_angle,
                traverse_steps_limit=samples_per_round,
                rays_mask=alive,
                max_lattice_steps=window,
                packed_grids=state.binaries_packed,
            )
        with record_function("compact_indices_from_counts"):
            gather_idx, ray_indices, kept = compact_indices_from_counts(
                res.num_valid, samples_per_round, n_alive * samples_per_round
            )
            t_starts = res.t_starts.reshape(-1)[gather_idx]
            t_ends = res.t_ends.reshape(-1)[gather_idx]
            t_ends = torch.where(kept, t_ends, t_starts)

        rgbs, sigmas = rgb_sigma_fn(t_starts, t_ends, ray_indices)
        with record_function("render_weight_from_density"):
            # Weights on the traversal's (n_rays, samples_per_round) rows:
            # each ray's transmittance is a cumsum over its own row, so no
            # rounding carries from one ray into the next.  Padding slots go
            # to a spare slot; empty row slots have t_start == t_end.
            slot = torch.where(kept, gather_idx, n_slots)
            sigma_rows = sigmas.new_zeros(n_slots + 1).scatter_(0, slot, sigmas)
            weights, _, alphas = render_weight_from_density(
                res.t_starts,
                res.t_ends,
                sigma_rows[:n_slots].view(n_rays, samples_per_round),
                prefix_trans=1.0 - opacity,
            )
            weights = torch.where(kept, weights.reshape(-1)[gather_idx], 0.0)
            if alpha_thre > 0:
                alphas = alphas.reshape(-1)[gather_idx]
                weights = torch.where(alphas >= alpha_thre, weights, 0.0)

        with record_function("accumulate_along_rays"):
            rgb = rgb + accumulate_along_rays(weights, rgbs, ray_indices, n_rays)
            opacity = opacity + accumulate_along_rays(weights, None, ray_indices, n_rays)
            depth = depth + accumulate_along_rays(
                weights * (t_starts + t_ends) / 2.0, None, ray_indices, n_rays
            )
        near_planes = res.termination_planes
        alive = (
            alive
            & (opacity[:, 0] <= 1.0 - early_stop_eps)
            & (near_planes < res.far_effective - 1e-6)
        )
        total_samples += kept.sum()
        iter_samples += samples_per_round

    if render_bkgd is not None:
        rgb = rgb + render_bkgd * (1.0 - opacity)
    depth = depth / opacity.clamp(min=torch.finfo(dtype).eps)
    return rgb, opacity, depth, int(total_samples)
