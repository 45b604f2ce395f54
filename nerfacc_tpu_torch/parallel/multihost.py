"""Joining a process group, the ``(hosts, chips)`` layout of its ranks, and
per-process ray input.

Port of ``nerfacc_tpu/parallel/multihost.py:44-142``:

- :func:`initialize_distributed` joins a ``torch.distributed`` process
  group (JAX's ``jax.distributed.initialize``), one rank per process and
  one device per rank;
- :func:`make_hybrid_mesh` lays the ranks out as ``(hosts, chips)``: rows
  are hosts, each row the ranks of one host in rank order, so a rank's place
  in the flattened layout is JAX's ``_linear_index`` (host-major, then chip);
- :func:`host_local_rays_to_global` takes the rays each rank loaded itself
  (:func:`process_local_batch_size` of them): no rank ever holds the global
  batch.

A single process that joins nothing gets a mesh of one rank, so the same
script runs from one process to many.
"""

from __future__ import annotations

import dataclasses
import os
import socket
import zlib
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, _local_card, _mesh, _tree_map

__all__ = [
    "initialize_distributed",
    "make_hybrid_mesh",
    "host_local_rays_to_global",
    "process_local_batch_size",
]

DCN_AXIS = "hosts"
ICI_AXIS = "chips"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: str = "nccl",
) -> Tuple[int, int]:
    """Join the process group; every process calls it once, before it
    builds a mesh (``multihost.py:44-68``).

    It joins only when more than one process is asked for or a coordinator
    address (``host:port`` or a ``tcp://`` URL) is given; without one the
    address, world size and rank come from the environment (``env://``,
    as ``torchrun`` sets them).  ``backend`` is ``"nccl"`` (one card a
    rank, :func:`~nerfacc_tpu_torch.parallel.mesh._local_card`, made the
    current device) unless the caller asks for ``"gloo"``; NCCL without a
    card raises, it never falls back to gloo.

    Returns ``(rank, world_size)``: ``(0, 1)`` without a join.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    want_multi = (num_processes is not None and num_processes > 1) or coordinator_address is not None
    if not want_multi:
        return 0, 1
    kwargs = {}
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend 'nccl' needs a CUDA device and none is available; pass backend='gloo' to join on the CPU"
            )
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        kwargs["device_id"] = torch.device("cuda", _local_card(rank))
        torch.cuda.set_device(kwargs["device_id"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend,
        init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        **kwargs,
    )
    return dist.get_rank(), dist.get_world_size()


def make_hybrid_mesh(
    group=None,
    *,
    dcn_axis: str = DCN_AXIS,
    ici_axis: str = ICI_AXIS,
    hosts: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
) -> Mesh:
    """2-D ``(hosts, chips)`` mesh over the ranks of ``group`` (default:
    every rank; ``multihost.py:71-108``).

    Rows are hosts: the ranks are grouped by host name (one ``all_reduce``
    of each rank's name hash), hosts in the order of their lowest rank and
    each host's ranks in rank order; every host must hold as many ranks.
    ``hosts`` instead cuts the ranks, in rank order, into that many rows of
    simulated hosts, as the JAX function cuts its local devices.
    """
    mesh = _mesh(group, (dcn_axis, ici_axis), None, device)
    ranks = np.arange(mesh.size)
    if hosts is None and mesh.joined:
        names = torch.zeros(mesh.size, dtype=torch.int64, device=mesh.device)
        names[mesh.rank] = zlib.crc32(socket.gethostname().encode())
        host_of = mesh.all_reduce(names).cpu().numpy()
        order = sorted(ranks, key=lambda r: (ranks[host_of == host_of[r]].min(), r))
        ranks = np.asarray(order)
        hosts = len(set(host_of.tolist()))
    h = int(hosts or 1)
    assert mesh.size % h == 0, f"{mesh.size} ranks not divisible into {h} hosts"
    return dataclasses.replace(mesh, layout=ranks.reshape(h, mesh.size // h))


def process_local_batch_size(global_batch: int) -> int:
    """Rays this process must load for a global batch of ``global_batch``
    (``multihost.py:116-122``)."""
    count = dist.get_world_size() if dist.is_initialized() else 1
    assert global_batch % count == 0, f"global batch {global_batch} not divisible by {count} processes"
    return global_batch // count


def host_local_rays_to_global(mesh: Mesh, tree: Any) -> Any:
    """Each rank's own rays, as the shard of the global batch it holds
    (``multihost.py:125-142``).

    Every rank passes only the rays it loaded; one ``all_reduce`` of the
    leaves' leading sizes checks that each rank holds
    :func:`process_local_batch_size` of the global batch (and every leaf as
    many rows), and the leaves come back on the mesh's device.
    """
    leaves = []
    _tree_map(leaves.append, tree)
    counts = torch.zeros((mesh.size, len(leaves)), dtype=torch.int64, device=mesh.device)
    counts[mesh.index] = torch.tensor([np.shape(x)[0] for x in leaves], dtype=torch.int64)
    counts = mesh.all_reduce(counts).cpu().numpy()
    local = int(counts[mesh.index, 0])
    if not (counts == local).all():
        raise ValueError(f"every rank must hold as many rays in every leaf: {counts.tolist()}")
    if mesh.group is None:
        assert local == process_local_batch_size(int(counts[:, 0].sum()))
    return _tree_map(lambda x: torch.as_tensor(x).to(mesh.device), tree)
