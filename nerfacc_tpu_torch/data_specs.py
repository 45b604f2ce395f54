"""Ray-segment containers (port of ``nerfacc_tpu/data_specs.py:31-71``).

Two layouts, as in the JAX package:

- **batched**: ``vals`` is ``(n_rays, n)``; the row is the ray.
- **flat**: ``vals`` is ``(N,)`` with ``packed_info`` (each ray's start and
  count) and optionally ``ray_indices`` and masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class RaySamples:
    """Samples along rays; batched ``(n_rays, n_samples)`` or flat ``(N,)``.

    ``packed_info`` is an optional ``(n_rays, 2)`` (start, count) table of
    the flat chunks, ``ray_indices`` each flat sample's ray, ``is_valid`` a
    mask of ``vals``'s shape.
    """

    vals: Tensor
    packed_info: Optional[Tensor] = None
    ray_indices: Optional[Tensor] = None
    is_valid: Optional[Tensor] = None

    @property
    def is_batched(self) -> bool:
        return self.vals.ndim > 1


@dataclasses.dataclass(frozen=True)
class RayIntervals:
    """Interval edges along rays; batched ``(n_rays, n_edges)`` or flat
    ``(N,)``.  ``is_left`` / ``is_right`` say whether an edge is the left or
    right end of some interval (an interior edge is both); batched edges may
    leave them ``None``."""

    vals: Tensor
    packed_info: Optional[Tensor] = None
    ray_indices: Optional[Tensor] = None
    is_left: Optional[Tensor] = None
    is_right: Optional[Tensor] = None

    @property
    def is_batched(self) -> bool:
        return self.vals.ndim > 1
