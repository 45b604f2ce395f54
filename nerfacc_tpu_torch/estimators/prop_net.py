"""Proposal-network transmittance estimator (Mip-NeRF 360 style).

Port of ``nerfacc_tpu/estimators/prop_net.py``.  As in the JAX package, the
estimator is a configuration object: :meth:`PropNetEstimator.sampling`
returns each level's ``(intervals, cdfs)`` as a cache, and
:meth:`PropNetEstimator.compute_loss` is a function of that cache and the
final transmittance, so one backward of ``render_loss + prop_loss``
reaches the field and the proposal nets together and the caller steps two
optimizers.  Sample positions carry no gradient, and the final histogram is
detached before the PDF loss (``prop_net.py:83,88-89,99-100,112``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..data_specs import RayIntervals
from ..device import resolve_device
from ..pdf import importance_sampling, searchsorted
from ..volrend import render_transmittance_from_density
from .base import AbstractEstimator

Tensor = torch.Tensor

PropCache = List[Tuple[Tensor, Optional[Tensor]]]  # [(interval edges in s, cdfs)]


class PropNetEstimator(AbstractEstimator):
    """Proposal-network estimator (``prop_net.py:36-146``).  The proposal
    nets' parameters and their optimizer belong to the caller."""

    def sampling(
        self,
        prop_sigma_fns: Sequence[Callable],
        prop_samples: Sequence[int],
        num_samples: int,
        n_rays: int,
        near_plane: float,
        far_plane: float,
        sampling_type: str = "lindisp",
        stratified: bool = False,
        requires_grad: bool = False,
        jitter: Optional[Sequence[Tensor]] = None,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> Tuple[Tensor, Tensor, PropCache]:
        """Resample ``[near_plane, far_plane]`` through the proposal levels
        (``prop_net.py:43-117``).

        ``prop_sigma_fns`` map ``(t_starts, t_ends)`` of shape ``(n_rays,
        n)`` to densities of that shape.  Stratified offsets come from
        ``jitter``, one ``(n_rays, 1)`` tensor a level and one for the final
        pass (the JAX package splits its key in that order), or from
        ``generator``.  Returns ``(t_starts, t_ends, cache)``, the final
        ``(n_rays, num_samples)`` intervals and the levels' cache.  With
        ``requires_grad`` False the proposal nets run under
        ``torch.no_grad()`` and the cache is empty.
        """
        if len(prop_sigma_fns) != len(prop_samples):
            raise ValueError("one proposal sample count per proposal function")
        if jitter is not None and len(jitter) != len(prop_samples) + 1:
            raise ValueError("jitter needs one tensor a level and one for the final pass")
        device = resolve_device(device)
        cdfs = torch.cat(
            [torch.zeros((n_rays, 1), device=device), torch.ones((n_rays, 1), device=device)], dim=-1
        )
        intervals = RayIntervals(vals=cdfs)
        cache: PropCache = []
        draws = list(jitter) if jitter is not None else [None] * (len(prop_samples) + 1)

        for level_fn, level_samples, draw in zip(prop_sigma_fns, prop_samples, draws):
            intervals, _ = importance_sampling(
                intervals, cdfs, level_samples, stratified, jitter=draw, generator=generator
            )
            t_vals = _transform_stot(sampling_type, intervals.vals, near_plane, far_plane).detach()
            t_starts, t_ends = t_vals[..., :-1], t_vals[..., 1:]
            with torch.set_grad_enabled(requires_grad and torch.is_grad_enabled()):
                sigmas = level_fn(t_starts, t_ends)
                if sigmas.shape != t_starts.shape:
                    raise ValueError(f"a proposal function returned {tuple(sigmas.shape)}, "
                                     f"expected {tuple(t_starts.shape)}")
                trans, _ = render_transmittance_from_density(t_starts, t_ends, sigmas)
                cdfs = 1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], dim=-1)
            if requires_grad:
                cache.append((intervals.vals, cdfs))
            # Resampling is not differentiable; the cache keeps the graph.
            intervals = RayIntervals(vals=intervals.vals.detach())
            cdfs = cdfs.detach()

        intervals, _ = importance_sampling(
            intervals, cdfs, num_samples, stratified, jitter=draws[-1], generator=generator
        )
        t_vals = _transform_stot(sampling_type, intervals.vals, near_plane, far_plane).detach()
        if requires_grad:
            cache.append((intervals.vals, None))
        return t_vals[..., :-1], t_vals[..., 1:], cache

    def compute_loss(self, cache: PropCache, trans: Tensor, loss_scaler: float = 1.0) -> Tensor:
        """PDF-matching loss between the final weights' histogram and each
        proposal level's (``prop_net.py:119-146``); ``trans`` is the final
        rendering's transmittance ``(n_rays, n)``.  Differentiable in the
        cached proposal cdfs only."""
        if len(cache) == 0:
            return torch.zeros((), device=trans.device)
        intervals_vals, _ = cache[-1]
        cdfs = (1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], dim=-1)).detach()
        loss = 0.0
        for prop_vals, prop_cdfs in cache[:-1][::-1]:
            loss = loss + torch.mean(
                _pdf_loss(RayIntervals(vals=intervals_vals), cdfs, RayIntervals(vals=prop_vals), prop_cdfs)
            )
        return loss * loss_scaler


def get_proposal_requires_grad_fn(target: float = 5.0, num_steps: int = 1000) -> Callable:
    """The annealed cadence of proposal updates (``prop_net.py:149-165``):
    called once a step with the step number, it says whether this step
    updates the proposal nets; from ``num_steps`` on, one step in
    ``target + 1``."""
    steps_since_last_grad = 0

    def proposal_requires_grad_fn(step: int) -> bool:
        nonlocal steps_since_last_grad
        requires_grad = steps_since_last_grad > min(step / num_steps, 1.0) * target
        if requires_grad:
            steps_since_last_grad = 0
        steps_since_last_grad += 1
        return requires_grad

    return proposal_requires_grad_fn


def _transform_stot(transform_type: str, s_vals: Tensor, t_min: float, t_max: float) -> Tensor:
    """s in [0, 1] to t (``prop_net.py:168-179``): linear in t
    (``"uniform"``) or in 1 / t (``"lindisp"``)."""
    if transform_type == "uniform":
        return s_vals * t_max + (1 - s_vals) * t_min
    if transform_type == "lindisp":
        return 1 / (s_vals * (1 / t_max) + (1 - s_vals) * (1 / t_min))
    raise ValueError(f"Unknown transform_type: {transform_type}")


def _pdf_loss(
    segments_query: RayIntervals,
    cdfs_query: Tensor,
    segments_key: RayIntervals,
    cdfs_key: Tensor,
    eps: float = 1e-7,
) -> Tensor:
    """Histogram-envelope loss, batched (``prop_net.py:182-198``)."""
    ids_left, ids_right = searchsorted(segments_key, segments_query)
    w = cdfs_query[..., 1:] - cdfs_query[..., :-1]
    w_outer = cdfs_key.gather(-1, ids_right[..., 1:]) - cdfs_key.gather(-1, ids_left[..., :-1])
    return (w - w_outer).clamp(min=0) ** 2 / (w + eps)


def _outer(t0_starts, t0_ends, t1_starts, t1_ends, y1):
    """The reference oracle (``prop_net.py:201-221``), for tests: the mass of
    histogram ``(t1, y1)`` over each interval of ``t0``."""
    cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)], dim=-1)
    last = y1.shape[-1] - 1
    idx_lo = (torch.searchsorted(t1_starts.contiguous(), t0_starts.contiguous(), right=True) - 1).clamp(0, last)
    idx_hi = torch.searchsorted(t1_ends.contiguous(), t0_ends.contiguous(), right=True).clamp(0, last)
    return cy1[..., 1:].gather(-1, idx_hi) - cy1[..., :-1].gather(-1, idx_lo)


def _lossfun_outer(t, w, t_env, w_env):
    """The reference oracle (``prop_net.py:224-230``), for tests."""
    eps = torch.finfo(t.dtype).eps
    w_outer = _outer(t[..., :-1], t[..., 1:], t_env[..., :-1], t_env[..., 1:], w_env)
    return (w - w_outer).clamp(min=0) ** 2 / (w + eps)
