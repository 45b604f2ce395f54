"""Occupancy-grid estimator: state, construction and grid replacement.

Port of ``nerfacc_tpu/estimators/occ_grid.py:46-160``.  The state keeps the
boolean grid, its macro-skip grid, and bit-packed copies of both in the
port's own layout (``(levels, rx, ry, ceil(rz / 32))`` int32 words, see
:func:`~nerfacc_tpu_torch.ops.occ_query.bitpack_grid`) for kernel K1.

``sampling``, the EMA update (``update_every_n_steps``/``_update``) and
``mark_invisible_cells`` serve the training path and come with it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..grid import _enlarge_aabb, build_skip_grid
from ..ops.occ_query import bitpack_grid
from .base import AbstractEstimator

Tensor = torch.Tensor


@dataclasses.dataclass
class OccGridState:
    """State of :class:`OccGridEstimator`.

    ``occs`` holds per-cell EMA occupancy; ``binaries`` the thresholded
    boolean grid per level; ``*_packed`` their bit-packed copies.
    """

    aabbs: Tensor  # (levels, 6)
    occs: Tensor  # (levels * cells_per_lvl,)
    binaries: Tensor  # (levels, rx, ry, rz) bool
    binaries_packed: Tensor  # (levels, rx, ry, ceil(rz/32)) int32
    skip_grid: Tensor  # (levels, rx/f, ry/f, rz/f) bool

    def replace(self, **changes) -> "OccGridState":
        return dataclasses.replace(self, **changes)


class OccGridEstimator(AbstractEstimator):
    """Occupancy grid estimator over ``levels`` 2x-nested boxes.

    Args:
        roi_aabb: region-of-interest box, 6 floats.
        resolution: grid resolution (int or 3 ints). Default 128.
        levels: number of 2x-nested levels. Default 1.
        skip_factor: macro-skip grid factor; lowered to the largest factor
            that divides every axis.
    """

    DIM: int = 3

    def __init__(
        self,
        roi_aabb: Union[Sequence[float], np.ndarray],
        resolution: Union[int, Sequence[int]] = 128,
        levels: int = 1,
        skip_factor: int = 2,
    ) -> None:
        if isinstance(resolution, int):
            resolution = [resolution] * self.DIM
        resolution = tuple(int(r) for r in resolution)
        assert len(resolution) == self.DIM
        requested_skip = max(1, int(skip_factor))
        skip_factor = requested_skip
        while any(r % skip_factor for r in resolution):
            skip_factor -= 1
        if skip_factor != requested_skip:
            warnings.warn(
                f"skip_factor={requested_skip} does not divide resolution "
                f"{resolution}; lowered to {skip_factor}",
                stacklevel=2,
            )
        self.skip_factor = skip_factor
        roi_aabb = np.asarray(roi_aabb, dtype=np.float32)
        assert roi_aabb.shape[0] == self.DIM * 2

        self.resolution = resolution
        self.levels = int(levels)
        self.cells_per_lvl = int(np.prod(resolution))
        self.roi_aabb = roi_aabb
        roi = torch.from_numpy(roi_aabb)
        self._aabbs_np = np.stack(
            [_enlarge_aabb(roi, 2**i).numpy() for i in range(self.levels)]
        )
        # Static scene extent for sizing the traversal lattice.
        outer = self._aabbs_np[-1]
        self.max_t_range = float(np.linalg.norm(outer[3:] - outer[:3]))

    def init(self, device: Union[str, torch.device] = "cuda") -> OccGridState:
        """Empty grid state on ``device``."""
        device = resolve_device(device)
        binaries = torch.zeros(
            (self.levels,) + self.resolution, dtype=torch.bool, device=device
        )
        return OccGridState(
            aabbs=torch.from_numpy(self._aabbs_np).to(device),
            occs=torch.zeros(
                (self.levels * self.cells_per_lvl,), dtype=torch.float32, device=device
            ),
            **self._grids(binaries),
        )

    def set_binaries(self, state: OccGridState, binaries: Tensor) -> OccGridState:
        """Replace the binary grid and rebuild the skip grid and the packed
        copy (a stale skip grid or packed grid would answer for the old
        occupancy)."""
        binaries = binaries.to(device=state.binaries.device, dtype=torch.bool)
        return state.replace(**self._grids(binaries))

    def _grids(self, binaries: Tensor) -> dict:
        """``binaries`` with its packed copy and its skip grid."""
        assert binaries.shape == (self.levels,) + self.resolution
        return dict(
            binaries=binaries,
            binaries_packed=bitpack_grid(binaries),
            skip_grid=build_skip_grid(binaries, self.skip_factor),
        )
