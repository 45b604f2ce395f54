"""Render drivers: the occupancy-grid training and inference renderers, and
the proposal-network renderer.

Port of ``nerfacc_tpu/rendering.py:38-475``.

:func:`occgrid_render_rays` is the training path: one fused traversal and
compaction into a fixed sample capacity
(:func:`~nerfacc_tpu_torch.grid.traverse_and_compact`), the field on the
flat samples, and differentiable volume rendering with the sorted
``seg_bounds`` accumulation; optionally a visibility filter (a density
pass without gradients, in its own ``visibility`` range) ahead of the
field, and a second compaction of the survivors (``refilter_capacity``).

:func:`occgrid_render_rays_test` is the iterative alive-ray
renderer (Instant-NGP style).  Each round traverses a bounded window of
``samples_per_round`` samples per alive ray, compacts the valid samples,
queries the field on them, and accumulates colour, opacity and depth with
the transmittance carried over from earlier rounds.  A ray stops when its
opacity passes ``1 - early_stop_eps`` or its termination plane reaches the
far plane, and the loop stops after ``max_samples`` per ray.

:func:`propnet_render_rays` resamples each ray through the proposal
levels (:class:`~nerfacc_tpu_torch.estimators.prop_net.PropNetEstimator`)
and renders the final batched samples.

Eager PyTorch has dynamic shapes, so each round's compaction capacity is
``n_alive * samples_per_round`` rather than one of the JAX package's fixed
capacity buckets.  The result does not depend on it: no round can hold more
valid samples than that.

Each stage of a round runs inside a ``torch.profiler.record_function``
range, so a profile attributes device time to the stage.  Without a running
profiler a range costs a few microseconds of host time per round.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from .estimators.occ_grid import OccGridEstimator, OccGridState
from .estimators.prop_net import PropNetEstimator
from .grid import chunked_ray_components, num_ladder_steps, traverse_grids
from .grid import traverse_and_compact  # noqa: F401  (importable from here, as from the JAX module)
from .pack import compact_indices_from_counts
from .volrend import (
    accumulate_along_rays,
    render_visibility_from_density,
    render_weight_from_density,
    rendering,
)

Tensor = torch.Tensor


def gather_ray_od(
    rays_o: Tensor, rays_d: Tensor, ray_indices: Tensor
) -> Tuple[Tensor, Tensor]:
    """Per-sample ``(origins, directions)`` through one ``(n, 6)`` row
    gather.  It is ``index_select``, whose backward (when the rays need a
    gradient, as BARF's do) is one ``index_add_``: the padding slots all
    name one ray, and the backward of advanced indexing adds the duplicates
    of one index one after another."""
    g = torch.index_select(torch.cat([rays_o, rays_d], dim=-1), 0, ray_indices.long())
    return g[:, :3], g[:, 3:]


def occgrid_render_rays(
    rgb_sigma_fn: Callable,  # (t_starts, t_ends, ray_indices) -> (rgb, sigma)
    sigma_fn: Optional[Callable],  # the same arguments -> sigma
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
    early_stop_eps: float = 1e-4,
    stratified: bool = False,
    jitter: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
    max_samples_per_ray: Optional[int] = None,
    sample_capacity: Optional[int] = None,
    max_macro_segments: int = 24,
    refilter_capacity: Optional[int] = None,
    rgb_sigma_soa_fn: Optional[Callable] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor, dict]:
    """Render a ray batch for training (``rendering.py:101-278``).

    Returns ``(colors (n,3), opacities (n,1), depths (n,1),
    n_rendering_samples, extras)``, differentiable in the field's
    parameters; ``extras`` adds ``kept``, ``ray_indices``,
    ``macro_truncated_frac``, ``n_traversed`` (the samples the traversal
    found within each ray's budget), ``n_over_capacity`` (those of them that
    found no slot in ``sample_capacity``: the last rays' samples) and
    ``n_visible`` (the samples the visibility filter kept, which may exceed
    ``refilter_capacity``) to :func:`~nerfacc_tpu_torch.volrend.rendering`'s.
    With ``stratified``, each ray's near plane moves by ``jitter *
    render_step_size`` (``jitter`` an ``(n_rays,)`` tensor in ``[0, 1)``, or
    drawn from ``generator``).

    ``sigma_fn`` runs only for the visibility filter, when ``alpha_thre >
    0`` or ``refilter_capacity`` is set (``rendering.py:196-249``): a density
    pass without gradients drops the samples whose transmittance is below
    ``early_stop_eps`` or whose alpha is below ``min(alpha_thre,
    mean(state.occs))``.  With ``refilter_capacity`` the surviving samples
    are compacted again into that many slots, so the differentiable pass
    runs on fewer samples; that layout is no longer sorted by ray (its
    padding decodes to the first slot's ray), so the per-ray sums take
    ``index_add_``.

    With ``rgb_sigma_soa_fn`` the field is called as ``rgb_sigma_soa_fn((ox,
    oy, oz), (dx, dy, dz), t_starts, t_ends)`` on each slot's ray
    components (``rendering.py:172-255``), gathered by ``ray_indices`` after
    the refilter (the JAX package carries them through its compaction and
    permutes them with the refilter's samples: the same floats);
    ``rgb_sigma_fn`` is then not called.
    """
    n_rays = rays_o.shape[0]
    with record_function("traverse_and_compact"):
        cs = estimator.compact_samples(
            state, rays_o, rays_d, near_plane=near_plane, far_plane=far_plane,
            render_step_size=render_step_size, stratified=stratified,
            cone_angle=cone_angle, jitter=jitter, generator=generator,
            max_samples=max_samples_per_ray, sample_capacity=sample_capacity,
            max_macro_segments=max_macro_segments,
        )
    ray_indices, t_starts, t_ends, kept = cs.ray_indices, cs.t_starts, cs.t_ends, cs.kept
    seg_bounds = (cs.seg_starts, cs.seg_counts)
    n_traversed = cs.num_valid.sum()
    over_capacity = n_traversed - kept.sum()
    visible = None
    if sigma_fn is not None and (alpha_thre > 0.0 or refilter_capacity):
        with record_function("visibility"), torch.no_grad():
            sigmas = torch.where(kept, sigma_fn(t_starts, t_ends, ray_indices), 0.0)
            masks = render_visibility_from_density(
                t_starts, t_ends, sigmas, ray_indices=ray_indices,
                early_stop_eps=early_stop_eps,
                alpha_thre=state.occs.mean().clamp(max=alpha_thre),
            )
            kept = kept & masks
            visible = kept.sum()
            t_ends = torch.where(kept, t_ends, t_starts)
            if refilter_capacity:
                # The samples are sorted by ray, so a survivor's slot is the
                # count of survivors before it.  Dropped and overflowing
                # samples all write the spare last slot, which is cut off.
                slot = torch.cumsum(kept, 0) - 1
                slot = torch.where(kept, slot, refilter_capacity).clamp(max=refilter_capacity)
                src = torch.zeros(refilter_capacity + 1, dtype=torch.int64, device=kept.device)
                src = src.scatter_(0, slot, torch.arange(kept.shape[0], device=kept.device))
                src = src[:refilter_capacity]
                ray_indices, t_starts, t_ends = ray_indices[src], t_starts[src], t_ends[src]
                kept = torch.arange(refilter_capacity, device=kept.device) < visible
                t_ends = torch.where(kept, t_ends, t_starts)
                seg_bounds = None
    # The field runs in its own range, before rendering, so that a profile
    # tells the two apart.
    with record_function("field_forward"):
        if rgb_sigma_soa_fn is not None:
            # The refilter's layout is not chunk-aligned: one gather a slot.
            comps = chunked_ray_components(rays_o, rays_d, ray_indices, chunk=1)
            field_out = rgb_sigma_soa_fn(*comps, t_starts, t_ends)
        else:
            field_out = rgb_sigma_fn(t_starts, t_ends, ray_indices)
    with record_function("rendering"):
        colors, opacities, depths, extras = rendering(
            t_starts,
            t_ends,
            ray_indices=ray_indices,
            n_rays=n_rays,
            rgb_sigma_fn=lambda *_: field_out,
            render_bkgd=render_bkgd,
            is_valid=kept,
            seg_bounds=seg_bounds,
        )
    extras = dict(extras)
    extras["kept"] = kept
    extras["ray_indices"] = ray_indices
    extras["macro_truncated_frac"] = cs.macro_truncated.float().mean()
    extras["n_traversed"] = n_traversed
    extras["n_over_capacity"] = over_capacity
    extras["n_visible"] = kept.sum() if visible is None else visible
    return colors, opacities, depths, kept.sum(), extras


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
    lattice_per_round: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, int]:
    """Render ``rays_o/rays_d (n, 3)`` on their device.

    A round traverses ``samples_per_round`` samples a ray within a window of
    ``lattice_per_round`` lattice steps (by default ``min(full lattice,
    8 * samples_per_round)``, ``rendering.py:321``).

    Returns ``(rgb (n,3), opacity (n,1), depth (n,1), total_samples)``.
    """
    n_rays = rays_o.shape[0]
    dtype, device = rays_o.dtype, rays_o.device

    full_lattice = num_ladder_steps(
        estimator.max_t_range, render_step_size, cone_angle, near=near_plane
    )
    window = lattice_per_round or min(full_lattice, samples_per_round * 8)
    rgb_sigma_fn = rgb_sigma_fn_builder(rays_o, rays_d)

    near_planes = torch.full((n_rays,), near_plane, dtype=dtype, device=device)
    far_planes = torch.full((n_rays,), far_plane, dtype=dtype, device=device)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=device)
    rgb = torch.zeros((n_rays, 3), dtype=dtype, device=device)
    opacity = torch.zeros((n_rays, 1), dtype=dtype, device=device)
    depth = torch.zeros((n_rays, 1), dtype=dtype, device=device)
    total_samples = torch.zeros((), dtype=torch.int64, device=device)

    carry = (near_planes, alive, rgb, opacity, depth)
    iter_samples = 0
    while iter_samples < max_samples:
        n_alive = int(carry[1].sum())
        if n_alive == 0:
            break
        carry, n_kept = _test_round(
            rgb_sigma_fn, state, rays_o, rays_d, far_planes, carry, n_alive,
            samples_per_round=samples_per_round, window=window, render_step_size=render_step_size,
            cone_angle=cone_angle, alpha_thre=alpha_thre, early_stop_eps=early_stop_eps,
        )
        total_samples += n_kept
        iter_samples += samples_per_round
    _, _, rgb, opacity, depth = carry

    if render_bkgd is not None:
        rgb = rgb + render_bkgd * (1.0 - opacity)
    depth = depth / opacity.clamp(min=torch.finfo(dtype).eps)
    return rgb, opacity, depth, int(total_samples)


def _test_round(
    rgb_sigma_fn: Callable,
    state: OccGridState,
    rays_o: Tensor,
    rays_d: Tensor,
    far_planes: Tensor,
    carry: Tuple[Tensor, Tensor, Tensor, Tensor, Tensor],
    n_alive: int,
    *,
    samples_per_round: int,
    window: int,
    render_step_size: float,
    cone_angle: float,
    alpha_thre: float,
    early_stop_eps: float,
) -> Tuple[Tuple[Tensor, Tensor, Tensor, Tensor, Tensor], Tensor]:
    """One round of the inference renderer on the rays' own device: traverse
    a window of ``samples_per_round`` samples per alive ray (``n_alive`` of
    them), compact them, query the field and accumulate.  ``carry`` is
    ``(near_planes, alive, rgb, opacity, depth)``; returns the next carry and
    the round's kept-sample count (on the device)."""
    near_planes, alive, rgb, opacity, depth = carry
    n_rays = rays_o.shape[0]
    n_slots = n_rays * samples_per_round
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
    return (near_planes, alive, rgb, opacity, depth), kept.sum()


def propnet_render_rays(
    rgb_sigma_fn: Callable,  # batched (t_starts, t_ends) -> (rgb, sigma)
    prop_sigma_fns: Sequence[Callable],
    estimator: PropNetEstimator,
    rays_o: Tensor,
    rays_d: Tensor,
    *,
    num_samples: int = 48,
    prop_samples: Sequence[int] = (256, 96),
    near_plane: float = 0.2,
    far_plane: float = 1e3,
    sampling_type: str = "lindisp",
    opaque_bkgd: bool = True,
    render_bkgd: Optional[Tensor] = None,
    stratified: bool = False,
    requires_grad: bool = False,
    jitter: Optional[Sequence[Tensor]] = None,
    generator: Optional[torch.Generator] = None,
):
    """Render a ray batch through proposal-network resampling
    (``rendering.py:419-475``, ``examples/utils.py:155-249``).

    The estimator resamples ``[near_plane, far_plane]`` through
    ``prop_sigma_fns`` (stratified offsets from ``jitter`` or ``generator``,
    see :meth:`PropNetEstimator.sampling`) on the rays' device, the field
    runs on the final ``(n_rays, num_samples)`` intervals, and
    :func:`~nerfacc_tpu_torch.volrend.rendering` renders them batched.  With
    ``opaque_bkgd`` the last interval's density is set to inf, out of place,
    so that no gradient reaches the field there (``.at[..., -1].set(inf)``);
    a last interval of zero width then renders NaN, as in the JAX package.
    Returns ``(colors, opacities, depths, extras)``; ``extras`` adds
    ``prop_cache``, ``t_starts`` and ``t_ends`` to the renderer's, and
    ``prop_cache`` with ``extras["trans"]`` feed
    :meth:`PropNetEstimator.compute_loss`.
    """
    with record_function("prop_sampling"):
        t_starts, t_ends, cache = estimator.sampling(
            prop_sigma_fns=prop_sigma_fns,
            prop_samples=list(prop_samples),
            num_samples=num_samples,
            n_rays=rays_o.shape[0],
            near_plane=near_plane,
            far_plane=far_plane,
            sampling_type=sampling_type,
            stratified=stratified,
            requires_grad=requires_grad,
            jitter=jitter,
            generator=generator,
            device=rays_o.device,
        )
    with record_function("field_forward"):
        rgb, sigma = rgb_sigma_fn(t_starts, t_ends)
        if opaque_bkgd:
            sigma = torch.cat([sigma[..., :-1], torch.full_like(sigma[..., -1:], float("inf"))], dim=-1)
    with record_function("rendering"):
        colors, opacities, depths, extras = rendering(
            t_starts, t_ends, rgb_sigma_fn=lambda *_: (rgb, sigma), render_bkgd=render_bkgd
        )
    extras = dict(extras, prop_cache=cache, t_starts=t_starts, t_ends=t_ends)
    return colors, opacities, depths, extras
