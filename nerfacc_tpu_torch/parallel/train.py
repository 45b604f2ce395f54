"""Data-parallel train steps, the max-merged occupancy update and the
sharded inference renderer.

Port of ``nerfacc_tpu/parallel/train.py:44-442``.  Each rank renders its
own shard of the rays with local shapes (traversal, compaction, field,
scans, accumulation), so no collective touches the render; the only
traffic between ranks is

- one ``all_reduce`` a train step: the flattened gradients with the loss
  and the sample count in one buffer, summed, the gradients and the loss
  then divided by the world size (JAX's one fused ``psum`` of the mean
  loss's gradient);
- two ``all_reduce(MAX)`` an occupancy update: each rank probes its own
  cells and the grids merge by ``max`` (JAX's ``pmax``);
- one ``all_reduce`` of the alive count after each round of the
  inference renderer, read on the host so that every rank runs as many
  rounds, and one that assembles the image.

Parameters and optimizer state live in the ``nn.Module`` and the
``torch.optim`` optimizer, which every rank holds (see
:func:`~nerfacc_tpu_torch.parallel.mesh.replicate`); a step updates them
in place.  Random draws come in as tensors (the stratified jitter, the
update's ``draws``) or from a generator seeded per rank, the counterpart of
JAX's ``fold_in(key, rank)``.  Every function reduces over all the mesh's
axes (JAX's default ``axis=None``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..estimators.occ_grid import OccGridEstimator, OccGridState
from ..grid import num_ladder_steps
from ..rendering import _test_round, gather_ray_od, occgrid_render_rays, propnet_render_rays
from .mesh import Mesh, _check_axis, shard_rays

Tensor = torch.Tensor

__all__ = [
    "make_parallel_train_step",
    "make_parallel_occ_update",
    "make_parallel_propnet_train_step",
    "make_parallel_test_renderer",
]

# n_samples travels in the float32 buffer as (n // 2^12, n % 2^12): each part
# sums exactly while the world holds fewer than 2^12 ranks of 2^24 samples.
_N_SPLIT = 4096


def rank_generator(mesh: Mesh, seed: int, stream: int = 0) -> torch.Generator:
    """A generator on the mesh's device seeded from ``(seed, stream, rank's
    shard index)``: each rank draws its own numbers, the counterpart of
    ``fold_in(key, _linear_index(axis))``."""
    state = np.random.SeedSequence([seed, stream, mesh.index]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=mesh.device).manual_seed(int(state) >> 1)


def _reduce_mean_grads(mesh: Mesh, params: Sequence[Tensor], scalars: List[Tensor]) -> Tensor:
    """One ``all_reduce``: every parameter's gradient (zeros where it has
    none) and ``scalars`` summed over the ranks; the gradients come back as
    ``p.grad`` divided by the world size.  Returns the summed scalars."""
    flat = torch.cat(
        [(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1).float() for p in params]
        + [s.reshape(1).float() for s in scalars]
    )
    mesh.all_reduce(flat)
    n = flat.shape[0] - len(scalars)
    grads = flat[:n].div_(mesh.size)
    offset = 0
    for p in params:
        p.grad = grads[offset:offset + p.numel()].view_as(p).to(p.dtype)
        offset += p.numel()
    return flat[n:]


def make_parallel_train_step(
    field: torch.nn.Module,
    estimator: OccGridEstimator,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    *,
    render_step_size: float,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    cone_angle: float = 0.0,
    alpha_thre: float = 0.0,
    sample_capacity_per_shard: int = 1 << 15,
    max_macro_segments: int = 24,
    axis=None,
    seed: int = 0,
) -> Callable:
    """A data-parallel NGP-occ train step (``train.py:44-141``).

    Returns ``train_step(occ_state, rays_o, rays_d, pixels, bkgd,
    jitter=None) -> (loss, n_samples)``: ``rays_o``, ``rays_d`` and
    ``pixels`` are this rank's shard, ``jitter`` its ``(n_local,)``
    stratified offsets in ``[0, 1)`` (default: drawn from
    :func:`rank_generator`).  Each rank renders its shard through
    :func:`~nerfacc_tpu_torch.rendering.occgrid_render_rays` into
    ``sample_capacity_per_shard`` slots, takes the Huber loss and runs
    backward; one ``all_reduce`` then gives every rank the gradient of the
    global mean loss, which ``optimizer`` applies.  ``loss`` is that global
    mean and ``n_samples`` the kept samples over all ranks, both 0-d
    tensors on the device: nothing in the step waits for the host.
    """
    _check_axis(mesh, axis)
    params = [p for p in field.parameters() if p.requires_grad]
    generator = rank_generator(mesh, seed)

    def rgb_sigma_fn_of(rays_o, rays_d):
        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            o, d = gather_ray_od(rays_o, rays_d, ray_indices)
            rgb, sigma = field(o + ((t_starts + t_ends) / 2.0)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return rgb_sigma_fn

    def sigma_fn_of(rays_o, rays_d):
        def sigma_fn(t_starts, t_ends, ray_indices):
            o, d = gather_ray_od(rays_o, rays_d, ray_indices)
            return field.query_density(o + ((t_starts + t_ends) / 2.0)[:, None] * d)[..., 0]

        return sigma_fn

    def train_step(occ_state: OccGridState, rays_o, rays_d, pixels, bkgd, jitter: Optional[Tensor] = None):
        if jitter is None:
            jitter = torch.rand((rays_o.shape[0],), generator=generator, device=mesh.device)
        colors, _, _, n_samp, _ = occgrid_render_rays(
            rgb_sigma_fn_of(rays_o, rays_d), sigma_fn_of(rays_o, rays_d), estimator, occ_state, rays_o, rays_d,
            near_plane=near_plane, far_plane=far_plane, render_step_size=render_step_size, render_bkgd=bkgd,
            cone_angle=cone_angle, alpha_thre=alpha_thre, stratified=True, jitter=jitter,
            sample_capacity=sample_capacity_per_shard, max_macro_segments=max_macro_segments,
        )
        loss = F.huber_loss(colors, pixels, delta=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        sums = _reduce_mean_grads(
            mesh, params, [loss.detach(), n_samp // _N_SPLIT, n_samp % _N_SPLIT]
        )
        optimizer.step()
        n_total = sums[1].to(torch.int64) * _N_SPLIT + sums[2].to(torch.int64)
        return sums[0] / mesh.size, n_total

    return train_step


def make_parallel_occ_update(
    field: torch.nn.Module,
    estimator: OccGridEstimator,
    mesh: Mesh,
    *,
    render_step_size: float,
    axis=None,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    seed: int = 0,
) -> Callable:
    """A sharded occupancy update (``train.py:144-195``).

    Returns ``occ_update(occ_state, draws=None) -> occ_state``.  Each rank
    runs :meth:`OccGridEstimator._update` at a post-warmup step on its own
    draws (``draws`` as :meth:`OccGridEstimator.make_draws` gives them,
    ``sysrow`` draws with an ``offset`` or ``uniform`` ones with ``unit``
    or ``ranks``; default: ``sysrow`` draws from :func:`rank_generator`),
    then one ``all_reduce(MAX)``
    merges ``occs`` and one merges ``binaries`` (as int32), as JAX's
    ``pmax`` does: a cell is occupied where any rank's own threshold says
    so.  The skip grid and both packed grids are then rebuilt from the
    merged binaries (:meth:`OccGridEstimator.set_binaries`); the JAX
    function keeps each device's own, built from its binaries before the
    merge.  Where a cell is probed by some ranks only, the others keep its
    occupancy undecayed, so the merge is ``max(occ, probe)`` there, where
    one update on all the ranks' draws would give ``max(decay * occ,
    probe)``: the JAX function's semantics, kept.
    """
    _check_axis(mesh, axis)
    generator = rank_generator(mesh, seed, stream=1)

    def occ_eval_fn(x):
        return field.query_density(x) * render_step_size

    @torch.no_grad()
    def occ_update(occ_state: OccGridState, draws=None) -> OccGridState:
        if draws is None:
            draws = estimator.make_draws(10**9, generator, device=mesh.device)
        draw_mode = "uniform" if "unit" in draws[0] or "ranks" in draws[0] else "sysrow"
        new = estimator._update(
            occ_state, step=10**9, occ_eval_fn=occ_eval_fn, occ_thre=occ_thre, ema_decay=ema_decay,
            draws=draws, draw_mode=draw_mode,
        )
        occs = mesh.all_reduce(new.occs.clone(), op="max")
        binaries = mesh.all_reduce(new.binaries.to(torch.int32), op="max")
        return estimator.set_binaries(new.replace(occs=occs), binaries.bool())

    return occ_update


def make_parallel_propnet_train_step(
    field: torch.nn.Module,
    prop_nets: Sequence[torch.nn.Module],
    estimator,
    optimizer_field: torch.optim.Optimizer,
    optimizer_prop: torch.optim.Optimizer,
    mesh: Mesh,
    *,
    num_samples: int = 48,
    prop_samples: Sequence[int] = (256, 96),
    near_plane: float = 0.2,
    far_plane: float = 1e3,
    sampling_type: str = "lindisp",
    opaque_bkgd: bool = True,
    prop_loss_scaler: float = 1.0,
    axis=None,
    seed: int = 0,
) -> Callable:
    """A data-parallel proposal-network train step (``train.py:198-309``).

    Returns ``step(rays_o, rays_d, pixels, bkgd, jitter=None,
    requires_grad=True) -> (loss, mse, prop_loss)``, each the mean over
    all ranks (``loss`` is the Huber loss plus the proposal loss).
    ``jitter`` is this rank's list of ``(n_local, 1)`` offsets, one a
    proposal level and one for the final pass (default: from
    :func:`rank_generator`).  Each rank renders its shard through
    :func:`~nerfacc_tpu_torch.rendering.propnet_render_rays`; one
    ``all_reduce`` carries the field's gradients, the proposal nets' (when
    ``requires_grad``) and the three losses.  ``optimizer_field`` always
    steps, ``optimizer_prop`` only when ``requires_grad``, as the JAX step
    applies ``tx_prop`` only then.
    """
    _check_axis(mesh, axis)
    field_params = [p for p in field.parameters() if p.requires_grad]
    prop_params = [p for net in prop_nets for p in net.parameters() if p.requires_grad]
    generator = rank_generator(mesh, seed, stream=2)

    def step(rays_o, rays_d, pixels, bkgd, jitter=None, requires_grad: bool = True):
        def rgb_sigma_fn(t_starts, t_ends):
            x = rays_o[:, None] + ((t_starts + t_ends) / 2.0)[..., None] * rays_d[:, None]
            rgb, sigma = field(x, rays_d[:, None].expand(x.shape))
            return rgb, sigma[..., 0]

        prop_fns = [
            (lambda t_starts, t_ends, net=net: net(
                rays_o[:, None] + ((t_starts + t_ends) / 2.0)[..., None] * rays_d[:, None]
            )[..., 0])
            for net in prop_nets
        ]
        colors, _, _, extras = propnet_render_rays(
            rgb_sigma_fn, prop_fns, estimator, rays_o, rays_d, num_samples=num_samples,
            prop_samples=list(prop_samples), near_plane=near_plane, far_plane=far_plane,
            sampling_type=sampling_type, opaque_bkgd=opaque_bkgd, render_bkgd=bkgd, stratified=True,
            requires_grad=requires_grad, jitter=jitter, generator=None if jitter is not None else generator,
        )
        loss = F.huber_loss(colors, pixels, delta=1.0)
        mse = torch.mean((colors - pixels) ** 2)
        prop_loss = estimator.compute_loss(extras["prop_cache"], extras["trans"], loss_scaler=prop_loss_scaler)
        total = loss + prop_loss
        optimizer_field.zero_grad(set_to_none=True)
        optimizer_prop.zero_grad(set_to_none=True)
        total.backward()
        params = field_params + (prop_params if requires_grad else [])
        sums = _reduce_mean_grads(mesh, params, [total.detach(), mse.detach(), prop_loss.detach()])
        optimizer_field.step()
        if requires_grad:
            optimizer_prop.step()
        loss_m, mse_m, prop_m = (sums / mesh.size).unbind()
        return loss_m, mse_m, prop_m

    return step


def make_parallel_test_renderer(
    field: torch.nn.Module,
    estimator: OccGridEstimator,
    mesh: Mesh,
    *,
    render_step_size: float,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    cone_angle: float = 0.0,
    alpha_thre: float = 0.0,
    early_stop_eps: float = 1e-4,
    samples_per_round: int = 32,
    max_samples: int = 1024,
    axis=None,
) -> Callable:
    """A sharded iterative alive-ray inference renderer
    (``train.py:312-442``).

    Returns ``render(occ_state, rays_o, rays_d, render_bkgd=None) -> (rgb,
    opacity, depth, n_rounds)``.  Every rank passes all ``n_rays`` rays
    (``n_rays`` a multiple of the mesh's size) and renders its shard
    (:func:`~nerfacc_tpu_torch.parallel.mesh.shard_rays`) in rounds of the
    single-process renderer's body (the window traversal, compaction, field
    and accumulation of
    :func:`~nerfacc_tpu_torch.rendering.occgrid_render_rays_test`), with no
    collective inside a round.  After each round one ``all_reduce`` of the
    alive count is read on the host, so that every rank runs the same number
    of rounds (a rank with no alive ray left skips the round's work);
    ``n_rounds`` is that number.  One ``all_reduce`` of the zero-padded
    shards then gives every rank the whole image.
    """
    _check_axis(mesh, axis)
    window = min(
        num_ladder_steps(estimator.max_t_range, render_step_size, cone_angle, near=near_plane),
        samples_per_round * 8,
    )

    @torch.no_grad()
    def render(occ_state: OccGridState, rays_o, rays_d, render_bkgd=None):
        n_rays = rays_o.shape[0]
        assert n_rays % mesh.size == 0, (n_rays, mesh.size)
        o, d = shard_rays((rays_o, rays_d), mesh, axis=mesh.axis_names)
        n_local, dtype, device = o.shape[0], o.dtype, o.device

        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            ro, rd = gather_ray_od(o, d, ray_indices)
            rgb, sigma = field(ro + ((t_starts + t_ends) / 2.0)[:, None] * rd, rd)
            return rgb, sigma[..., 0]

        far_planes = torch.full((n_local,), far_plane, dtype=dtype, device=device)
        carry = (
            torch.full((n_local,), near_plane, dtype=dtype, device=device),
            torch.ones((n_local,), dtype=torch.bool, device=device),
            torch.zeros((n_local, 3), dtype=dtype, device=device),
            torch.zeros((n_local, 1), dtype=dtype, device=device),
            torch.zeros((n_local, 1), dtype=dtype, device=device),
        )
        n_alive, n_alive_all, n_rounds = n_local, n_rays, 0
        for _ in range(max(1, max_samples // samples_per_round)):
            if n_alive_all == 0:
                break
            if n_alive > 0:
                carry, _ = _test_round(
                    rgb_sigma_fn, occ_state, o, d, far_planes, carry, n_alive,
                    samples_per_round=samples_per_round, window=window, render_step_size=render_step_size,
                    cone_angle=cone_angle, alpha_thre=alpha_thre, early_stop_eps=early_stop_eps,
                )
            n_rounds += 1
            local = carry[1].sum().reshape(1)
            n_alive, n_alive_all = torch.cat([local, mesh.all_reduce(local.clone())]).tolist()
        _, _, rgb, opacity, depth = carry
        k = mesh.index * n_local
        out = torch.zeros((n_rays, 5), dtype=dtype, device=device)
        out[k:k + n_local] = torch.cat([rgb, opacity, depth], dim=-1)
        rgb, opacity, depth = mesh.all_reduce(out).split([3, 1, 1], dim=-1)
        if render_bkgd is not None:
            rgb = rgb + render_bkgd * (1.0 - opacity)
        depth = depth / opacity.clamp(min=torch.finfo(dtype).eps)
        return rgb, opacity, depth, n_rounds

    return render
