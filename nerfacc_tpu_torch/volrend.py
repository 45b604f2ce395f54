"""Volume rendering over batched or flat ray samples (forward).

Port of ``nerfacc_tpu/volrend.py:44-184,251-364``.  Transmittance is
``exp(-exclusive_sum(sigma * dt))``; invalid (capacity-padding) samples carry
``t_start == t_end`` and are exact no-ops.  Flat per-ray sums go through
``index_add_`` (on the card an atomic add, so their order, and the last bits
of the result, vary from run to run).

The ``seg_bounds`` sorted accumulation and its exact-gather VJP
(``volrend.py:185-248``) come with the training slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .scan import exclusive_prod, exclusive_sum

Tensor = torch.Tensor

__all__ = [
    "rendering",
    "render_transmittance_from_alpha",
    "render_transmittance_from_density",
    "render_weight_from_alpha",
    "render_weight_from_density",
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
) -> Tuple[Tensor, Tensor, Tensor, Dict]:
    """Volume rendering orchestrator (forward).

    The network is called as ``rgb_sigma_fn(t_starts, t_ends, ray_indices)``
    (or ``rgb_alpha_fn``); ``is_valid`` zeroes densities/alphas at padding.
    Returns ``(colors (n,3), opacities (n,1), depths (n,1), extras)``.
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
