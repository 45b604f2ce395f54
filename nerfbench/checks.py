"""The numbers that decide ``correct`` for a training cell, and the rays
and pixels of a training batch worked out again from the views.

Colours: the median over the rays that have samples of the largest
channel gap of the first step's rendered colours, the forward pass from
the same weights (from scratch, the first step's 2^18 slots hold the
samples of its first few hundred rays only, and the other rays render
the background alike).  The sums
over samples that make the gradients' norms differ by float32 rounding do
not enter it, and a grid cell that float32 rounding flips at the
occupancy threshold moves only the few rays through it, which the median
leaves out; so it is the number that tells a lower-precision forward pass
(which moves every ray) from a sound one.
Losses: the largest relative gap over the checked steps.  Gradient and
change: the worst leaf's gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf.  A leaf whose first reference gradient is under a
thousandth of the median leaf's moves under Adam by round-off alone and is
left out of the change.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import scene

Tensor = torch.Tensor
NEGLIGIBLE = 1e-3


def loss_gap(program: Sequence[float], reference: Sequence[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float], leaves: List[str]) -> Dict[str, float]:
    """Each leaf's gap, over the larger of its reference norm and the
    median leaf's (the median taken over ``leaves``)."""
    med = statistics.median(reference[k] for k in leaves)
    return {k: abs(program[k] - reference[k]) / max(reference[k], med, 1e-30) for k in leaves}


def moving_leaves(ref_first_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_first_grad.values())
    return [k for k, v in ref_first_grad.items() if v >= NEGLIGIBLE * med]


def norms(tensors: Dict[str, Tensor]) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in tensors.items()}


def rays_from_batch(o: Tensor, d: Tensor, bkgd: Tensor, images: Tensor, c2w: Tensor, focal: float):
    """The batch's rays and pixels worked out again: each ray's view is the
    camera at its origin, its pixel the projection of its direction; the
    ray through that pixel's centre and the view's RGBA over the batch's
    background.  ``images`` ``(n, h, w, 4)`` uint8 and ``c2w`` ``(n, 4,
    4)`` on the rays' device.  Returns ``(origins, directions, pixels)``."""
    n_views, h, w = images.shape[:3]
    view = torch.cdist(o, c2w[:, :3, 3]).argmin(dim=-1)
    rot = c2w[view, :3, :3]
    cam = (d[:, :, None] * rot).sum(dim=1)  # R^T d
    x = torch.round(cam[:, 0] / -cam[:, 2] * focal + w / 2.0 - 0.5).long().clamp(0, w - 1)
    y = torch.round(-cam[:, 1] / -cam[:, 2] * focal + h / 2.0 - 0.5).long().clamp(0, h - 1)
    o2, d2 = scene.pixel_rays(x.float(), y.float(), focal, w, h, c2w[view, :3, :4])
    rgba = images[view, y, x].float() / 255.0
    pixels = rgba[:, :3] * rgba[:, 3:] + bkgd * (1.0 - rgba[:, 3:])
    return o2, d2, pixels


def step_seed(seed: int, step: int, kind: int) -> int:
    """A generator seed for one step's draws of one kind."""
    return (int(seed) * 1_000_003 + int(step) * 16 + kind) % (1 << 62)


@contextlib.contextmanager
def recording_colours(module, name: str, into: list):
    """Patches ``module.name``, a renderer whose first output is the rays'
    colours, to keep a copy of them in ``into``."""
    render = getattr(module, name)

    def recorded(*args, **kwargs):
        out = render(*args, **kwargs)
        into.append(out[0].detach().clone())
        return out

    setattr(module, name, recorded)
    try:
        yield
    finally:
        setattr(module, name, render)


def colour_gap(program: Tensor, reference: Tensor, rays: Tensor) -> float:
    """The median over ``rays`` (those the reference gave samples) of each
    ray's largest channel gap of the rendered colours; 1 (the widest gap of
    colours in [0, 1]) where the program rendered another number of rays."""
    if program.shape != reference.shape:
        return 1.0
    return float((program.double() - reference.double())[rays].abs().amax(dim=-1).median())


class RecordingLoader:
    """The program's loader, keeping the batches it hands out while
    ``batches`` is a list."""

    def __init__(self, loader):
        self.loader = loader
        self.batches = None

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):  # the ray count and its update
        return getattr(self.loader, name)

    def __getitem__(self, index):
        batch = self.loader[index]
        if self.batches is not None:
            self.batches.append(batch)
        return batch


def psnr(img: Tensor, target: Tensor) -> float:
    mse = float(torch.mean((img.float() - target.float()) ** 2))
    return float(-10.0 * np.log10(max(mse, 1e-12)))


def composite_white(rgba_uint8: np.ndarray, device) -> Tensor:
    rgba = torch.from_numpy(rgba_uint8).to(device).float() / 255.0
    return rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
