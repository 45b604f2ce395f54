"""The rank mesh: which process holds which shard of a ray batch, and the
two collectives the parallel layer uses.

Port of ``nerfacc_tpu/parallel/mesh.py:36-61``.  A JAX mesh is a grid of
devices that one program drives; here each rank of a
``torch.distributed`` process group drives one device, and :class:`Mesh`
records the group, this rank, the group's size, the axis names, the device
and the layout of the group's ranks over those axes.  A ray batch shards
along its leading axis in layout order (``Shard(0)``, JAX's
``P("data")``); parameters, optimizer state and the occupancy grid are
replicated (``Replicate()``, JAX's ``P()``), made equal by a broadcast from
the layout's first rank.

The layer's only collectives are ``all_reduce`` and ``broadcast``: both run
over NCCL and, on CPU or CUDA tensors, over gloo.  Without a process group
(one process that joined nothing) a mesh has one rank and both are the
identity.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.profiler import record_function

from ..device import resolve_device
from ..estimators.occ_grid import OccGridState

__all__ = [
    "make_mesh",
    "shard_rays",
    "replicate",
    "data_sharding",
    "replicated_sharding",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks of one process group laid out over named axes.

    ``layout`` holds the group ranks, shaped by ``axis_names`` (``(size,)``
    for :func:`make_mesh`, ``(hosts, chips)`` for
    :func:`~nerfacc_tpu_torch.parallel.multihost.make_hybrid_mesh`);
    ``index`` is this rank's place in the flattened layout, the shard it
    holds (JAX's ``_linear_index``, host-major, then chip).
    """

    group: Optional[Any]  # a ProcessGroup; None for the default group
    rank: int  # this process's rank in ``group``
    size: int
    axis_names: tuple
    device: torch.device
    layout: np.ndarray
    joined: bool  # whether collectives run (False: one process, no group)

    @property
    def index(self) -> int:
        return int(np.flatnonzero(self.layout.reshape(-1) == self.rank)[0])

    def all_reduce(self, tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``tensor`` in place over the group (``"sum"`` or ``"max"``),
        inside an ``all_reduce`` profiler range."""
        if self.joined:
            with record_function("all_reduce"):
                dist.all_reduce(
                    tensor, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op], group=self.group
                )
        return tensor

    def broadcast_(self, tensor: torch.Tensor) -> torch.Tensor:
        """Overwrite ``tensor`` with the layout's first rank's copy.  A tensor
        on another device than the mesh's (Adam's step counter lies on the
        CPU, which NCCL cannot reach) or of type bool (which gloo does not
        take) goes through a copy on the mesh's device."""
        if not self.joined:
            return tensor
        src = int(self.layout.reshape(-1)[0])
        if self.group is not None:
            src = dist.get_global_rank(self.group, src)
        buf = tensor.detach()
        if buf.device != self.device or buf.dtype == torch.bool or not buf.is_contiguous():
            tmp = buf.to(self.device, torch.uint8 if buf.dtype == torch.bool else buf.dtype).contiguous()
            dist.broadcast(tmp, src, group=self.group)
            buf.copy_(tmp)
        else:
            dist.broadcast(buf, src, group=self.group)
        return tensor


def _local_card(rank: int) -> int:
    """The card of global rank ``rank`` on its host: ``LOCAL_RANK`` where
    the launcher sets it (``torchrun``), else ``rank % device_count``.
    :func:`~nerfacc_tpu_torch.parallel.multihost.initialize_distributed`
    binds NCCL to this card and a mesh on ``"cuda"`` computes on it, so
    both rules are this one."""
    return int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))


def _mesh(group, axis_names: tuple, layout_shape: Optional[tuple], device) -> Mesh:
    joined = dist.is_available() and dist.is_initialized()
    if joined:
        if group is not None and group == dist.GroupMember.NON_GROUP_MEMBER:
            raise ValueError("this process is not a member of the group")
        rank, size = dist.get_rank(group), dist.get_world_size(group)
    elif group is not None:
        raise ValueError("a group was given, but this process joined no process group")
    else:
        rank, size = 0, 1
    layout = np.arange(size).reshape(layout_shape or (size,))
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", _local_card(dist.get_rank()) if joined else 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group, rank, size, tuple(axis_names), device, layout, joined)


def make_mesh(group=None, axis: str = "data", device: Union[str, torch.device] = "cuda") -> Mesh:
    """1-D mesh over the ranks of ``group`` (default: every rank) on the
    ``axis`` axis, in rank order (``mesh.py:36-41``).  ``device="cuda"``
    takes this rank's card, :func:`_local_card`."""
    return _mesh(group, (axis,), None, device)


def _check_axis(mesh: Mesh, axis) -> None:
    """The port splits and reduces over every axis of a mesh: ``axis`` must
    name them all (a name or a tuple), or be ``None``."""
    names = (axis,) if isinstance(axis, str) else axis
    if axis is not None and set(names) != set(mesh.axis_names):
        raise ValueError(f"the port splits over every mesh axis {mesh.axis_names}, not {axis!r}")


def data_sharding(mesh: Mesh, axis="data") -> Shard:
    """The ray batch's placement: split along its leading axis over every
    rank of the mesh (``mesh.py:44-45``, ``P("data")``)."""
    _check_axis(mesh, axis)
    return Shard(0)


def replicated_sharding(mesh: Mesh) -> Replicate:
    """Parameters', optimizer state's and the grid's placement: a copy on
    every rank (``mesh.py:48-49``, ``P()``)."""
    return Replicate()


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return type(tree)((k, _tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_rays(tree: Any, mesh: Mesh, axis="data") -> Any:
    """This rank's contiguous slice of every leaf's leading axis, on the
    mesh's device: shard ``mesh.index`` of ``mesh.size`` equal ones, as a
    JAX ``P("data")`` shard (``mesh.py:52-55``).  ``axis`` names every axis
    of the mesh (``mesh.axis_names`` on a hybrid one).  Every rank passes
    the whole batch; see
    :func:`~nerfacc_tpu_torch.parallel.multihost.host_local_rays_to_global`
    for ranks that load only their own rays."""
    _check_axis(mesh, axis)

    def shard(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"{x.shape[0]} rows do not split over {mesh.size} ranks")
        k = x.shape[0] // mesh.size
        return x[mesh.index * k:(mesh.index + 1) * k].to(mesh.device).contiguous()

    return _tree_map(shard, tree)


def replicate(tree: Any, mesh: Mesh) -> Any:
    """Every leaf made equal to the layout's first rank's: an ``nn.Module``'s
    parameters and buffers and an optimizer's state tensors in place, an
    :class:`OccGridState`'s tensors and other tensors as copies on the
    mesh's device (``mesh.py:58-61``).  Modules and optimizers come back as
    they went in."""

    def copy(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                mesh.broadcast_(t.data)
            return x
        if isinstance(x, torch.optim.Optimizer):
            for state in x.state.values():
                for v in state.values():
                    if torch.is_tensor(v):
                        mesh.broadcast_(v)
            return x
        if isinstance(x, OccGridState):
            return OccGridState(**{
                f.name: copy(getattr(x, f.name)) for f in dataclasses.fields(OccGridState)
            })
        return mesh.broadcast_(torch.as_tensor(x).to(mesh.device, copy=True))

    return _tree_map(copy, tree)
