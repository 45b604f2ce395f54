"""Volume rendering over batched or flat ray samples.

Port of ``nerfacc_tpu/volrend.py:44-364``.  Transmittance is
``exp(-exclusive_sum(sigma * dt))``; invalid (capacity-padding) samples carry
``t_start == t_end`` and are exact no-ops.  Flat per-ray sums go through
``index_add_`` (on the card an atomic add, so their order, and the last bits
of the result, vary from run to run), or, for samples grouped by ray with
``seg_bounds``, through one cumulative sum and two boundary gathers, whose
backward is the exact gather ``dsrc[i] = dout[ray_indices[i]]``.  Gradients
of the rest come from autograd, through the float64 segmented sums of
:mod:`~nerfacc_tpu_torch.scan`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import torch

from .pack import pack_info  # noqa: F401  (importable from here, as from the JAX module)
from .scan import exclusive_prod, exclusive_sum

Tensor = torch.Tensor

__all__ = [
    "rendering",
    "render_transmittance_from_alpha",
    "render_transmittance_from_density",
    "render_weight_from_alpha",
    "render_weight_from_density",
    "render_visibility_from_alpha",
    "render_visibility_from_density",
    "accumulate_along_rays",
]


def render_transmittance_from_alpha(
    alphas: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[Tensor] = None,
) -> Tensor:
    """T_i = prod_{j<i} (1 - alpha_j)."""
    trans = exclusive_prod(1.0 - alphas, packed_info=packed_info, ray_indices=ray_indices)
    if prefix_trans is not None:
        trans = trans * prefix_trans
    return trans


def render_transmittance_from_density(
    t_starts: Tensor,
    t_ends: Tensor,
    sigmas: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """T_i = exp(-sum_{j<i} sigma_j dt_j); returns ``(trans, alphas)``."""
    sigmas_dt = sigmas * (t_ends - t_starts)
    alphas = 1.0 - torch.exp(-sigmas_dt)
    acc = exclusive_sum(sigmas_dt, packed_info=packed_info, ray_indices=ray_indices)
    trans = torch.exp(-acc)
    if prefix_trans is not None:
        trans = trans * prefix_trans
    return trans, alphas


def render_weight_from_alpha(
    alphas: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """w_i = T_i * alpha_i; returns ``(weights, trans)``."""
    trans = render_transmittance_from_alpha(
        alphas, packed_info, ray_indices, n_rays, prefix_trans
    )
    return trans * alphas, trans


def render_weight_from_density(
    t_starts: Tensor,
    t_ends: Tensor,
    sigmas: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """w_i = T_i * (1 - exp(-sigma_i dt_i)); returns ``(weights, trans,
    alphas)``.  ``prefix_trans`` scales every T_i (per sample), which is how
    the inference renderer carries transmittance across rounds."""
    trans, alphas = render_transmittance_from_density(
        t_starts, t_ends, sigmas, packed_info, ray_indices, n_rays, prefix_trans
    )
    return trans * alphas, trans, alphas


def render_visibility_from_alpha(
    alphas: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre: Union[float, Tensor] = 0.0,
    prefix_trans: Optional[Tensor] = None,
) -> Tensor:
    """``vis = (T >= early_stop_eps) & (alpha >= alpha_thre)``
    (``volrend.py:117-139``).  ``alpha_thre`` may be a 0-d tensor on the
    device (the estimator ties it to the grid's mean occupancy), so it is
    applied unconditionally; at 0 it keeps every non-negative alpha."""
    trans = render_transmittance_from_alpha(
        alphas, packed_info, ray_indices, n_rays, prefix_trans
    )
    return (trans >= early_stop_eps) & (alphas >= alpha_thre)


def render_visibility_from_density(
    t_starts: Tensor,
    t_ends: Tensor,
    sigmas: Tensor,
    packed_info: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre: Union[float, Tensor] = 0.0,
    prefix_trans: Optional[Tensor] = None,
) -> Tensor:
    """:func:`render_visibility_from_alpha` from densities
    (``volrend.py:142-159``)."""
    trans, alphas = render_transmittance_from_density(
        t_starts, t_ends, sigmas, packed_info, ray_indices, n_rays, prefix_trans
    )
    return (trans >= early_stop_eps) & (alphas >= alpha_thre)


def accumulate_along_rays(
    weights: Tensor,
    values: Optional[Tensor] = None,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
) -> Tensor:
    """sum_i w_i v_i per ray: ``index_add_`` in flat mode, a sum over the
    sample axis in batched mode."""
    if values is None:
        src = weights[..., None]
    else:
        assert values.ndim == weights.ndim + 1
        src = weights[..., None] * values
    if ray_indices is not None:
        assert n_rays is not None, "n_rays must be provided with ray_indices"
        assert weights.ndim == 1, "weights must be flattened"
        out = src.new_zeros((n_rays,) + src.shape[1:])
        return out.index_add_(0, ray_indices.long(), src)
    return src.sum(dim=-2)


def _accumulate_sorted(src: Tensor, seg_starts: Tensor, seg_counts: Tensor) -> Tensor:
    """Per-ray sums of ``src (capacity, k)`` whose rows are grouped by ray in
    slot ranges ``[seg_starts, seg_starts + seg_counts)`` (the layout of
    :func:`~nerfacc_tpu_torch.grid.traverse_and_compact`): one cumulative
    sum and two boundary gathers (``volrend.py:185-211``).  The JAX package
    sums in float32, so a ray's sum inherits the rounding of the global
    prefix; the port sums in float64, which leaves each ray's sum exact to
    float32."""
    # Scan each column along its contiguous last axis: a cumsum over dim 0
    # of a narrow (capacity, 5) tensor runs one thread per column on the
    # card (100 ms at 2^19 samples, against well under 1 ms this way).
    cols = src.to(torch.float64).t().contiguous()  # (k, capacity)
    csum = torch.cat([cols.new_zeros((cols.shape[0], 1)), torch.cumsum(cols, dim=1)], dim=1)
    ends = (seg_starts + seg_counts).long()
    return (csum[:, ends] - csum[:, seg_starts.long()]).t().to(src.dtype)


class _AccumulateSortedG(torch.autograd.Function):
    """:func:`_accumulate_sorted` with the exact segment-sum backward
    (``volrend.py:214-248``): ``dsrc[i] = dout[ray_indices[i]]`` where
    ``valid[i]``, else 0 -- a row gather, not the cumulative sum's VJP."""

    @staticmethod
    def forward(ctx, src, seg_starts, seg_counts, ray_indices, valid):
        ctx.save_for_backward(ray_indices, valid)
        return _accumulate_sorted(src, seg_starts, seg_counts)

    @staticmethod
    def backward(ctx, dout):
        ray_indices, valid = ctx.saved_tensors
        d = dout[ray_indices.long().clamp(0, dout.shape[0] - 1)]
        return torch.where(valid[:, None], d, 0.0), None, None, None, None


def rendering(
    t_starts: Tensor,
    t_ends: Tensor,
    ray_indices: Optional[Tensor] = None,
    n_rays: Optional[int] = None,
    rgb_sigma_fn: Optional[Callable] = None,
    rgb_alpha_fn: Optional[Callable] = None,
    render_bkgd: Optional[Tensor] = None,
    is_valid: Optional[Tensor] = None,
    expected_depth: bool = True,
    seg_bounds: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Dict]:
    """Volume rendering orchestrator (``volrend.py:251-364``).

    The network is called as ``rgb_sigma_fn(t_starts, t_ends, ray_indices)``
    (or ``rgb_alpha_fn``); ``is_valid`` zeroes densities/alphas at padding.
    ``seg_bounds = (seg_starts, seg_counts)`` says the flat samples are
    grouped by ray; the per-ray sums then run as
    :func:`_accumulate_sorted` (with the exact-gather backward when
    ``is_valid`` is given).  Returns ``(colors (n,3), opacities (n,1),
    depths (n,1), extras)``.
    """
    if ray_indices is not None:
        assert t_starts.shape == t_ends.shape == ray_indices.shape, (
            "t_starts, t_ends and ray_indices must have the same shape"
        )
    if rgb_sigma_fn is None and rgb_alpha_fn is None:
        raise ValueError(
            "At least one of `rgb_sigma_fn` and `rgb_alpha_fn` should be specified."
        )

    if rgb_sigma_fn is not None:
        rgbs, sigmas = rgb_sigma_fn(t_starts, t_ends, ray_indices)
        assert rgbs.shape[-1] == 3, f"rgbs must have 3 channels, got {rgbs.shape}"
        assert sigmas.shape == t_starts.shape
        if is_valid is not None:
            sigmas = torch.where(is_valid, sigmas, 0.0)
        weights, trans, alphas = render_weight_from_density(
            t_starts, t_ends, sigmas, ray_indices=ray_indices, n_rays=n_rays
        )
        extras = {
            "weights": weights,
            "alphas": alphas,
            "trans": trans,
            "sigmas": sigmas,
            "rgbs": rgbs,
        }
    else:
        rgbs, alphas = rgb_alpha_fn(t_starts, t_ends, ray_indices)
        assert rgbs.shape[-1] == 3, f"rgbs must have 3 channels, got {rgbs.shape}"
        assert alphas.shape == t_starts.shape
        if is_valid is not None:
            alphas = torch.where(is_valid, alphas, 0.0)
        weights, trans = render_weight_from_alpha(
            alphas, ray_indices=ray_indices, n_rays=n_rays
        )
        extras = {"weights": weights, "trans": trans, "rgbs": rgbs, "alphas": alphas}

    if seg_bounds is not None and ray_indices is not None:
        src = torch.cat(
            [
                weights[:, None] * rgbs,
                weights[:, None],
                (weights * (t_starts + t_ends) / 2.0)[:, None],
            ],
            dim=-1,
        )  # (capacity, 5)
        if is_valid is not None:
            acc = _AccumulateSortedG.apply(src, *seg_bounds, ray_indices, is_valid)
        else:
            acc = _accumulate_sorted(src, *seg_bounds)
        colors, opacities, depths = acc[:, 0:3], acc[:, 3:4], acc[:, 4:5]
    else:
        colors = accumulate_along_rays(weights, rgbs, ray_indices, n_rays)
        opacities = accumulate_along_rays(weights, None, ray_indices, n_rays)
        depths = accumulate_along_rays(
            weights, ((t_starts + t_ends) / 2.0)[..., None], ray_indices, n_rays
        )
    if expected_depth:
        depths = depths / opacities.clamp(min=torch.finfo(rgbs.dtype).eps)
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    return colors, opacities, depths, extras
