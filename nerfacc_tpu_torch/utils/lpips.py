"""LPIPS (VGG16 trunk) perceptual metric.

Port of ``nerfacc_tpu/utils/lpips.py``: the VGG16 conv trunk, features at
relu1_2, relu2_2, relu3_3, relu4_3 and relu5_3, per-channel unit
normalisation, squared difference, a linear calibration per channel,
spatial mean, sum over the five stages (Zhang et al. 2018).

Weights, in order:

1. ``NERFACC_LPIPS_WEIGHTS``: a local ``.npz`` with torchvision's VGG16
   conv weights (``features.{i}.weight``/``bias``, OIHW) and the LPIPS
   calibration (``lin{k}``); the metric is then LPIPS-vgg (``"vgg"``).
2. Otherwise the same architecture with He-initialised filters from the
   fixed seed ``np.random.RandomState(0x1B515)`` and uniform calibration,
   drawn by the same numpy code as the JAX package's, so both packages build
   the same weights (``"rnd"``).  Scores from the two sources are not
   comparable, so every caller reports which one it used.
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

# VGG16 conv plan: (out_channels, n_convs) per stage; LPIPS taps the last
# relu of each stage.  torchvision `features` indices of the conv layers:
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_TORCH_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)

# ImageNet normalisation LPIPS applies after scaling images to [-1, 1].
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _conv_shapes() -> List[Tuple[int, int]]:
    """(in_ch, out_ch) for the 13 VGG16 convs, in order."""
    shapes = []
    c_in = 3
    for c_out, reps in _VGG_STAGES:
        for _ in range(reps):
            shapes.append((c_in, c_out))
            c_in = c_out
    return shapes


@functools.lru_cache(maxsize=1)
def _load_params() -> Tuple[tuple, tuple, str]:
    """``(conv (weight OIHW, bias) pairs, per-stage calibration, source)``."""
    path = os.environ.get("NERFACC_LPIPS_WEIGHTS", "")
    shapes = _conv_shapes()
    if path and os.path.exists(path):
        z = np.load(path)
        convs = []
        for j, torch_i in enumerate(_TORCH_CONV_IDX):
            w = z[f"features.{torch_i}.weight"]  # (O, I, H, W)
            if tuple(w.shape[:2][::-1]) != shapes[j]:
                raise ValueError(f"{path}: features.{torch_i}.weight has shape {w.shape}")
            convs.append((w.astype(np.float32), z[f"features.{torch_i}.bias"].astype(np.float32)))
        lins = tuple(z[f"lin{k}"].reshape(-1).astype(np.float32) for k in range(5))
        return tuple(convs), lins, "vgg"

    # He-init filters from a fixed seed, drawn in the JAX package's layout
    # (HWIO) and order, then turned to OIHW.
    rng = np.random.RandomState(0x1B515)
    convs = []
    for c_in, c_out in shapes:
        std = np.sqrt(2.0 / (9 * c_in))
        w = rng.normal(0.0, std, size=(3, 3, c_in, c_out)).astype(np.float32)
        convs.append((np.ascontiguousarray(w.transpose(3, 2, 0, 1)), np.zeros((c_out,), np.float32)))
    lins = tuple(np.full((c,), 1.0 / c, np.float32) for c, _ in _VGG_STAGES)
    return tuple(convs), lins, "rnd"


def _vgg_features(x: Tensor, convs) -> List[Tensor]:
    """``x`` (N, 3, H, W) normalised; the five tapped feature maps."""
    feats = []
    i = 0
    for stage, (_, reps) in enumerate(_VGG_STAGES):
        for _ in range(reps):
            w, b = convs[i]
            x = F.relu(F.conv2d(x, w, b, padding=1))
            i += 1
        feats.append(x)
        if stage < len(_VGG_STAGES) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _unit_normalize(f: Tensor) -> Tensor:
    return f * torch.rsqrt((f * f).sum(dim=1, keepdim=True) + 1e-10)


@torch.no_grad()
def _lpips(pred: Tensor, target: Tensor) -> Tensor:
    """Per-image LPIPS of ``(N, H, W, 3)`` images."""
    convs_np, lins_np, _ = _load_params()
    dev = pred.device
    convs = [(torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev)) for w, b in convs_np]
    shift = torch.from_numpy(_SHIFT).to(dev)
    scale = torch.from_numpy(_SCALE).to(dev)

    def prep(img):
        img = img * 2.0 - 1.0
        return ((img - shift) / scale).permute(0, 3, 1, 2)

    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        fp = _vgg_features(prep(pred), convs)
        ft = _vgg_features(prep(target), convs)
    total = torch.zeros(pred.shape[0], dtype=pred.dtype, device=dev)
    for a, b, lin in zip(fp, ft, lins_np):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        lin = torch.from_numpy(lin).to(dev)[None, :, None, None]
        total = total + (d * lin).sum(dim=1).mean(dim=(-2, -1))
    return total


def lpips(pred, target) -> Tuple[float, str]:
    """LPIPS distance between images in ``[0, 1]``, shape ``(H, W, 3)`` or
    ``(N, H, W, 3)`` (tensors on any device, or numpy arrays, which run on
    the CPU).  Returns ``(value, source)``, the mean over images and
    ``"vgg"`` or ``"rnd"`` (see the module docstring)."""
    _, _, src = _load_params()
    p = torch.as_tensor(pred, dtype=torch.float32)
    t = torch.as_tensor(target, dtype=torch.float32, device=p.device)
    if p.ndim == 3:
        p, t = p[None], t[None]
    return float(_lpips(p, t).mean()), src
