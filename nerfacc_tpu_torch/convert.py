"""Carry weights and occupancy trained by the JAX package into the port.

Inputs are numpy arrays (or anything ``np.asarray`` accepts); nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Mapping, Tuple, Union

import numpy as np
import torch

from .device import resolve_device
from .estimators.occ_grid import OccGridEstimator, OccGridState


def field_from_jax(params: Mapping) -> dict:
    """``state_dict`` for a field of ``models/ngp.py``
    (:class:`~nerfacc_tpu_torch.models.ngp.NGPRadianceField`,
    :class:`~nerfacc_tpu_torch.models.ngp.NGPDensityField`),
    ``models/tensorf.py`` (TensoRF, K-Planes) or ``models/tineuvox.py``
    (TiNeuVox) from the flax parameters of the JAX package's class of the
    same name, with or without the outer ``{"params": ...}`` level.

    Arrays keep their flax path (``encoder.table``, ``dp0``, ``sp2``,
    ``voxels.grid``); every encoder's table is one parameter laid out as the
    JAX encoder's: ``hash`` ``(L * T, F)``, ``soa`` ``(F, L * T)``,
    ``fused`` and ``folded`` ``(L * T, 8 F)``, ``grouped`` ``(G * T,
    128)``.  A flax ``Dense`` (``basis_mat``, ``sigma_head``) becomes the
    ``nn.Linear`` of the same name: flax kernels are ``(in, out)``,
    ``nn.Linear`` weights their transpose; the bias, if any, as it is.  flax
    names the dense layers of ``nn.Sequential`` ``layers_<i>`` by position,
    which is also their index in the port's ``nn.Sequential``.
    """
    state = {}

    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    def walk(tree: Mapping, path: tuple) -> None:
        for name, sub in tree.items():
            if not isinstance(sub, Mapping):
                state[".".join(path + (name,))] = tensor(sub)
            elif "kernel" not in sub:
                walk(sub, path + (name,))
            else:
                prefix = ".".join(path + (name.split("_")[1] if name.startswith("layers_") else name,))
                state[f"{prefix}.weight"] = tensor(np.asarray(sub["kernel"]).T)
                if "bias" in sub:
                    state[f"{prefix}.bias"] = tensor(sub["bias"])

    walk(params.get("params", params), ())
    return state


def mlp_field_from_jax(params: Mapping) -> dict:
    """``state_dict`` for :class:`~nerfacc_tpu_torch.models.mlp.VanillaNeRFRadianceField`,
    :class:`~nerfacc_tpu_torch.models.mlp.TNeRFRadianceField` or
    :class:`~nerfacc_tpu_torch.models.mlp.NDRTNeRFRadianceField` (or any
    module of ``models/mlp.py``) from the flax parameters of the JAX class of
    the same name, with or without the outer ``{"params": ...}`` level.

    flax names an ``MLP``'s dense layers ``Dense_0``, ``Dense_1``, ... in
    call order, the port's ``layers.0``, ``layers.1``, ...; a list of
    submodules ``warp_layers_1 = [...]`` is ``warp_layers_1_0``, ... in
    flax and the ``nn.ModuleList`` ``warp_layers_1.0``, ... in the port.
    ``Dense`` kernels are ``(in, out)``, ``nn.Linear`` weights their
    transpose.
    """
    state = {}

    def walk(tree: Mapping, path: tuple) -> None:
        for name, sub in tree.items():
            if "kernel" in sub:
                prefix = ".".join(path + ("layers", name.split("_")[1]))
                state[f"{prefix}.weight"] = torch.from_numpy(np.array(sub["kernel"], dtype=np.float32).T.copy())
                state[f"{prefix}.bias"] = torch.from_numpy(np.array(sub["bias"], dtype=np.float32))
            else:
                head, _, index = name.rpartition("_")
                walk(sub, path + ((head, index) if head and index.isdigit() else (name,)))

    walk(params.get("params", params), ())
    return state


def barf_from_jax(params: Mapping) -> Tuple[dict, dict]:
    """``(field, pose)`` ``state_dict``s for
    :class:`~nerfacc_tpu_torch.models.barf.BARFRadianceField` and
    :class:`~nerfacc_tpu_torch.models.barf.PoseRefine` from the BARF
    example's ``{"field": ..., "pose": {"params": {"pose_deltas"}}}``."""
    pose = params["pose"].get("params", params["pose"])
    return (
        mlp_field_from_jax(params["field"]),
        {"pose_deltas": torch.from_numpy(np.array(pose["pose_deltas"], dtype=np.float32))},
    )


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
