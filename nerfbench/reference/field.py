"""Plain Instant-NGP fields: the multiresolution hash encoding, degree-4
spherical harmonics and the two small MLPs (Mueller et al. 2022), in the
parametrisation of nerfacc's JAX and PyTorch examples:

- level ``l`` has ``floor(base * g^l)`` cells an axis, ``g =
  exp((ln max - ln base) / (L - 1))`` (computed in float64);
- a point ``x`` in ``[0, 1]^3`` sits at ``x * res`` on level ``l``; its
  cell's 8 vertices are looked up and blended trilinearly;
- a level whose ``(res + 1)^3`` vertices, computed in wrapping int32
  arithmetic, number at most ``T`` indexes its table densely (stride
  ``res + 1``), every other level by the xor of the vertex coordinates
  times ``(1, 2654435761, 805459861)``, both ``& (T - 1)``;
- the table is stored as ``U(0, 2e-4)`` and read as stored minus ``1e-4``;
- density ``exp(h - 1)`` whose gradient clamps ``h - 1`` at 15, zero
  outside the box; colour ``sigmoid`` of the head MLP on the SH encoding
  of the view direction and the 15 geometry features.

Parameters are plain tensors in a dict (see :func:`param_shapes`), so the
benchmark hands the reference the same seeded weights it loads into the
program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

Tensor = torch.Tensor

PRIMES = (1, 2654435761, 805459861)
CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def level_resolutions(n_levels: int, base: int, max_res: int) -> List[int]:
    if n_levels == 1:
        return [base]
    growth = np.exp((np.log(max_res) - np.log(base)) / (n_levels - 1))
    return [int(np.floor(base * growth**lvl)) for lvl in range(n_levels)]


def _as_int32(v: int) -> int:
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def dense_levels(resolutions: List[int], table_size: int) -> List[bool]:
    return [_as_int32((r + 1) ** 3) <= table_size for r in resolutions]


def hash_encode(x: Tensor, table: Tensor, enc: dict) -> Tensor:
    """Features ``(n, L * F)`` (level-major) of points ``x`` ``(n, 3)`` in
    ``[0, 1]``; ``table`` is ``(L * T, F)`` as stored."""
    T = 1 << enc["log2_hashmap_size"]
    res = level_resolutions(enc["n_levels"], enc["base_resolution"], enc["max_resolution"])
    dense = dense_levels(res, T)
    feats = []
    for lvl, r in enumerate(res):
        xl = x * float(r)
        c0f = torch.floor(xl)
        w = xl - c0f
        c0 = c0f.long()
        acc = 0.0
        for i, j, k in CORNERS:
            cx, cy, cz = c0[:, 0] + i, c0[:, 1] + j, c0[:, 2] + k
            if dense[lvl]:
                idx = (cx * (r + 1) + cy) * (r + 1) + cz
            else:
                idx = (cx * PRIMES[0]) ^ (cy * PRIMES[1]) ^ (cz * PRIMES[2])
            idx = (idx & (T - 1)) + lvl * T
            wx = w[:, 0] if i else 1.0 - w[:, 0]
            wy = w[:, 1] if j else 1.0 - w[:, 1]
            wz = w[:, 2] if k else 1.0 - w[:, 2]
            acc = acc + (table[idx] - 1e-4) * (wx * wy * wz)[:, None]
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def sh_deg4(d: Tensor) -> Tensor:
    """The 16 real spherical harmonics of degree < 4 of unit directions."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * x * y,
        -1.0925484305920792 * y * z,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * x * z,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * x * y * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


class _ExpClampedGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h):
        ctx.save_for_backward(h)
        return torch.exp(h)

    @staticmethod
    def backward(ctx, g):
        (h,) = ctx.saved_tensors
        return g * torch.exp(h.clamp(max=15.0))


def _mlp(h: Tensor, params: Dict[str, Tensor], prefix: str, n_layers: int) -> Tensor:
    for i in range(n_layers):
        h = h @ params[f"{prefix}.{i}.weight"].t() + params[f"{prefix}.{i}.bias"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def mlp_layers(field: dict) -> Dict[str, List[int]]:
    """Each MLP's widths, input first: the base MLP to the density and
    ``geo_feat_dim`` features, and with features a head MLP on them and
    the 16 SH coefficients to the colour."""
    enc = field["encoding"]
    latent = enc["n_levels"] * enc["n_features_per_level"]
    width, geo = field["mlp_width"], field["geo_feat_dim"]
    layers = {"mlp_base": [latent, width, 1 + geo]}
    if geo:
        layers["mlp_head"] = [16 + geo, width, width, 3]
    return layers


def param_shapes(field: dict) -> Dict[str, tuple]:
    """Name and shape of every parameter, named as the program's modules
    name theirs (``encoder.table``, ``mlp_base.0.weight``, ...)."""
    enc = field["encoding"]
    shapes = {"encoder.table": (enc["n_levels"] << enc["log2_hashmap_size"], enc["n_features_per_level"])}
    for prefix, widths in mlp_layers(field).items():
        for i, (fan_in, fan_out) in enumerate(zip(widths[:-1], widths[1:])):
            # nn.Sequential numbers its modules: Linear, ReLU, Linear, ...
            shapes[f"{prefix}.{2 * i}.weight"] = (fan_out, fan_in)
            shapes[f"{prefix}.{2 * i}.bias"] = (fan_out,)
    return shapes


def _seq_params(params: Dict[str, Tensor], prefix: str) -> Dict[str, Tensor]:
    """``prefix``'s linear layers renumbered 0, 1, ..."""
    names = sorted({int(k.split(".")[1]) for k in params if k.startswith(prefix + ".")})
    out = {}
    for i, n in enumerate(names):
        out[f"{prefix}.{i}.weight"] = params[f"{prefix}.{n}.weight"]
        out[f"{prefix}.{i}.bias"] = params[f"{prefix}.{n}.bias"]
    return out


def unit_box(x: Tensor, aabb: Tensor):
    u = (x - aabb[:3]) / (aabb[3:] - aabb[:3])
    return u, ((u > 0.0) & (u < 1.0)).all(dim=-1)


def density_and_features(x: Tensor, params: Dict[str, Tensor], field: dict, aabb: Tensor):
    """``(density (n,), geometry features (n, geo) or None)`` at world
    points ``x`` ``(n, 3)``."""
    u, inside = unit_box(x, aabb)
    enc = hash_encode(u, params["encoder.table"], field["encoding"])
    base = _seq_params(params, "mlp_base")
    h = _mlp(enc, base, "mlp_base", len(base) // 2)
    density = torch.where(inside, _ExpClampedGrad.apply(h[:, 0] - 1.0), 0.0)
    return density, (h[:, 1:] if h.shape[1] > 1 else None)


def radiance(x: Tensor, d: Tensor, params: Dict[str, Tensor], field: dict, aabb: Tensor):
    """``(rgb (n, 3), density (n,))`` at points ``x`` seen along unit
    directions ``d``."""
    density, geo = density_and_features(x, params, field, aabb)
    head = _seq_params(params, "mlp_head")
    rgb = torch.sigmoid(_mlp(torch.cat([sh_deg4(d), geo], dim=-1), head, "mlp_head", len(head) // 2))
    return rgb, density


def in_chunks(fn, n: int, chunk: int):
    """``fn(lo, hi)`` over ``[0, n)`` in chunks, outputs concatenated."""
    outs = [fn(lo, min(lo + chunk, n)) for lo in range(0, n, chunk)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def fan_in_std(fan_in: int) -> float:
    """The standard deviation of a LeCun-normal kernel truncated at two
    standard deviations (the std of the unit normal truncated to [-2, 2]
    is 0.87962566103423978)."""
    return math.sqrt(1.0 / fan_in) / 0.87962566103423978
