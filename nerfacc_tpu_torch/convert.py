"""Carry weights and occupancy trained by the JAX package into the port.

Inputs are numpy arrays (or anything ``np.asarray`` accepts); nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Union

import numpy as np
import torch

from .device import resolve_device
from .estimators.occ_grid import OccGridEstimator, OccGridState


def field_from_jax(params: Mapping) -> dict:
    """``state_dict`` for :class:`~nerfacc_tpu_torch.models.ngp.NGPRadianceField`
    from the flax parameters of ``nerfacc_tpu.models.ngp.NGPRadianceField``
    (fused encoder), with or without the outer ``{"params": ...}`` level.

    flax ``Dense`` kernels are ``(in, out)``; ``nn.Linear`` weights are their
    transpose.  flax names the dense layers of ``nn.Sequential`` by their
    position (``layers_0``, ``layers_2``, ...), which is also their index in
    the port's ``nn.Sequential``.
    """
    p = params.get("params", params)

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {"encoder.table": tensor(p["encoder"]["table"])}
    for mlp in ("mlp_base", "mlp_head"):
        for name, layer in p.get(mlp, {}).items():
            i = int(name.split("_")[-1])
            state[f"{mlp}.{i}.weight"] = tensor(np.asarray(layer["kernel"]).T)
            state[f"{mlp}.{i}.bias"] = tensor(layer["bias"])
    return state


def occ_state_from_jax(
    estimator: OccGridEstimator,
    state,
    device: Union[str, torch.device] = "cuda",
) -> OccGridState:
    """The port's :class:`OccGridState` from a JAX ``OccGridState`` (its
    ``aabbs``, ``occs`` and ``binaries``); the skip grid and both packed
    grids are rebuilt in the port's layout."""
    device = resolve_device(device)
    binaries = torch.from_numpy(np.array(state.binaries, dtype=bool)).to(device)
    return OccGridState(
        aabbs=torch.from_numpy(np.array(state.aabbs, dtype=np.float32)).to(device),
        occs=torch.from_numpy(np.array(state.occs, dtype=np.float32)).to(device),
        **estimator._grids(binaries),
    )
