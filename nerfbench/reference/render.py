"""Plain volume rendering, Huber loss, Adam and the proposal sampler.

Rendering: ``alpha_i = 1 - exp(-sigma_i dt_i)``, ``T_i = exp(-sum_{j<i}
sigma_j dt_j)``, ``w_i = T_i alpha_i``; a ray's colour is ``sum w_i rgb_i +
(1 - sum w_i) * background``.

Proposal sampling (Mip-NeRF 360, nerfacc ``PropNetEstimator``): each level
resamples ``n`` points by the inverse of the piecewise-linear CDF given at
the previous edges, at ``u_i = (i + b) / n`` with one stratified offset
``b`` a ray (a CDF step under 1e-10 gives its midpoint); the new edges are
the midpoints between the points, the ends half a gap outside, clamped to
the old ends.  ``s`` in ``[0, 1]`` maps to ``t = s far + (1 - s) near``.
The proposal loss is the mean of ``max(w - w_outer, 0)^2 / (w + 1e-7)``
over the final intervals, ``w_outer`` the proposal mass over the smallest
union of proposal intervals that covers each final interval.
"""

from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor


def composite_flat(ray: Tensor, t0: Tensor, t1: Tensor, rgb: Tensor, sigma: Tensor, n_rays: int, bkgd: Tensor):
    """Colours ``(n_rays, 3)`` of samples listed ray-major."""
    counts = torch.bincount(ray, minlength=n_rays)
    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(ray.shape[0], device=ray.device) - starts[ray]
    width = int(counts.max()) if ray.numel() else 1
    sdt = torch.zeros((n_rays, width), device=sigma.device).index_put((ray, col), sigma * (t1 - t0))
    rgb_d = torch.zeros((n_rays, width, 3), device=rgb.device).index_put((ray, col), rgb)
    return composite_dense(sdt, rgb_d, bkgd)[0]


def composite_dense(sdt: Tensor, rgb: Tensor, bkgd: Tensor):
    """``(colours (n, 3), transmittance (n, s))`` of rows of ``sigma * dt``."""
    alpha = 1.0 - torch.exp(-sdt)
    trans = torch.exp(-(torch.cumsum(sdt, dim=-1) - sdt))
    w = trans * alpha
    color = (w[..., None] * rgb).sum(dim=-2)
    return color + bkgd * (1.0 - w.sum(dim=-1, keepdim=True)), trans


def huber(pred: Tensor, target: Tensor) -> Tensor:
    return torch.nn.functional.huber_loss(pred, target, delta=1.0)


class Adam:
    """Adam (Kingma and Ba) with L2 weight decay added to the gradient, as
    ``torch.optim.Adam(weight_decay=)`` and optax's
    ``add_decayed_weights`` ahead of ``scale_by_adam`` define it."""

    def __init__(self, params: Dict[str, Tensor], eps: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), moments=None, count: int = 0):
        """``moments``: ``(m, v)`` dicts to start from, after ``count``
        steps (default: zeros, no step)."""
        self.params, self.eps, self.wd, self.betas = params, eps, weight_decay, betas
        m, v = moments or ({}, {})
        self.m = {k: m[k].clone() if k in m else torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: v[k].clone() if k in v else torch.zeros_like(p) for k, p in params.items()}
        self.t = count
        self.first_grad: Dict[str, Tensor] = {}

    @torch.no_grad()
    def step(self, grads: Dict[str, Tensor], lr: float) -> None:
        b1, b2 = self.betas
        self.t += 1
        for k, p in self.params.items():
            g = grads[k] + self.wd * p
            if self.t == 1:
                self.first_grad[k] = g.clone()
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k] / (1 - b2**self.t)).sqrt() + self.eps
            p.sub_(lr / (1 - b1**self.t) * self.m[k] / denom)


def resample(edges: Tensor, cdfs: Tensor, n: int, bias: Tensor) -> Tensor:
    """New edges ``(rays, n + 1)`` in ``s`` from edges and CDF values
    ``(rays, k)``; ``bias`` ``(rays, 1)`` the stratified offsets."""
    u0 = cdfs[:, :1]
    u = u0 + (torch.arange(n, device=edges.device, dtype=edges.dtype) + bias) * ((cdfs[:, -1:] - u0) / n)
    hi = torch.searchsorted(cdfs.contiguous(), u.contiguous(), right=True).clamp(max=cdfs.shape[1] - 1)
    lo = (hi - 1).clamp(min=0)
    c_lo, c_hi = cdfs.gather(1, lo), cdfs.gather(1, hi)
    e_lo, e_hi = edges.gather(1, lo), edges.gather(1, hi)
    span = c_hi - c_lo
    flat = span < 1e-10
    pts = torch.where(flat, (e_lo + e_hi) * 0.5, (u - c_lo) * (e_hi - e_lo) / torch.where(flat, 1.0, span) + e_lo)
    first = torch.maximum(pts[:, :1] - (pts[:, 1:2] - pts[:, :1]) * 0.5, edges[:, :1])
    last = torch.minimum(pts[:, -1:] + (pts[:, -1:] - pts[:, -2:-1]) * 0.5, edges[:, -1:])
    return torch.cat([first, (pts[:, 1:] + pts[:, :-1]) * 0.5, last], dim=-1)


def s_to_t(s: Tensor, near: float, far: float) -> Tensor:
    return s * far + (1 - s) * near


def proposal_loss(final_edges: Tensor, final_cdfs: Tensor, prop_edges: Tensor, prop_cdfs: Tensor) -> Tensor:
    n = prop_edges.shape[1]
    hi = torch.searchsorted(prop_edges.contiguous(), final_edges.contiguous(), right=True).clamp(max=n - 1)
    lo = (hi - 1).clamp(min=0)
    w = final_cdfs[:, 1:] - final_cdfs[:, :-1]
    w_outer = prop_cdfs.gather(1, hi[:, 1:]) - prop_cdfs.gather(1, lo[:, :-1])
    return ((w - w_outer).clamp(min=0) ** 2 / (w + 1e-7)).mean()


def grads_of(loss: Tensor, params: Dict[str, Tensor]) -> Dict[str, Tensor]:
    names = [k for k, v in params.items() if v.requires_grad]
    gs = torch.autograd.grad(loss, [params[k] for k in names], allow_unused=True)
    return {k: (torch.zeros_like(params[k]) if g is None else g) for k, g in zip(names, gs)}
