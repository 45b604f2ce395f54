"""Seeded initial weights, made on the device in two calls a field: the
tables ``U(0, 2e-4)`` (read as stored minus 1e-4, tcnn's ``U(-1e-4,
1e-4)``), every MLP kernel LeCun-normal truncated at two standard
deviations (drawn as the inverse normal CDF of uniforms between the two
tails), biases zero.  The same seed gives the same weights; the benchmark
loads them into the program and hands copies to the reference."""

from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.field import fan_in_std, param_shapes

Tensor = torch.Tensor


def seeded_weights(field: dict, seed: int, device) -> Dict[str, Tensor]:
    shapes = param_shapes(field)
    gen = torch.Generator(device=device).manual_seed(seed)
    table_shape = shapes["encoder.table"]
    table = torch.rand(table_shape, generator=gen, device=device) * 2e-4
    kernels = {k: s for k, s in shapes.items() if k.endswith(".weight")}
    total = sum(math.prod(s) for s in kernels.values())
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # the unit normal's CDF at -2
    u = lo + torch.rand((total,), generator=gen, device=device, dtype=torch.float64) * (1.0 - 2.0 * lo)
    z = (torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)).clamp(-2.0, 2.0).to(torch.float32)
    out = {"encoder.table": table}
    at = 0
    for name, shape in kernels.items():
        n = math.prod(shape)
        out[name] = z[at : at + n].view(shape) * fan_in_std(shape[1])
        out[name.replace(".weight", ".bias")] = torch.zeros(shape[0], device=device)
        at += n
    return {k: out[k] for k in shapes}


@torch.no_grad()
def load_into(module: torch.nn.Module, weights: Dict[str, Tensor]) -> None:
    """Copy ``weights`` into the module's parameters of the same names."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"parameters {sorted(params)} do not match the seeded weights {sorted(weights)}")
    for name, p in params.items():
        if p.shape != weights[name].shape:
            raise ValueError(f"{name}: program {tuple(p.shape)}, seeded {tuple(weights[name].shape)}")
        p.copy_(weights[name])
