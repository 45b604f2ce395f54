"""Occupancy-grid estimator: state, traversal planning, sampling and the
occupancy EMA update.

Port of ``nerfacc_tpu/estimators/occ_grid.py:46-725``.  The state keeps the
boolean grid, its macro-skip grid, and bit-packed copies of both in the
port's own layout (``(levels, rx, ry, ceil(rz / 32))`` int32 words, see
:func:`~nerfacc_tpu_torch.ops.occ_query.bitpack_grid`) for kernel K1.

Random draws (the stratified near-plane jitter, the cells an update probes
and the jitter inside them) are tensors the caller passes, or come from a
``torch.Generator``: ``jax.random`` bits cannot be reproduced, so the
parity tests hand both packages the same draws.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..device import resolve_device
from ..grid import (
    CompactSamples,
    _enlarge_aabb,
    build_skip_grid,
    num_ladder_steps,
    traverse_and_compact,
)
from ..ops.occ_query import bitpack_grid
from ..ops.table_grad import cell_max
from ..volrend import render_visibility_from_alpha, render_visibility_from_density
from .base import AbstractEstimator

Tensor = torch.Tensor

# The sysrow draw gathers rows of this many ranks of the sorted occupied list.
_ROW_WIDTH = 128
# At or above this many draws per level the EMA takes kernel K3 (the JAX
# package's "auto" rule, occ_grid.py:619-633).
_CELL_MAX_MIN_DRAWS = 1 << 19


@dataclasses.dataclass
class OccGridState:
    """State of :class:`OccGridEstimator`.

    ``occs`` holds per-cell EMA occupancy (``-1`` marks camera-invisible
    cells); ``binaries`` the thresholded boolean grid per level; ``*_packed``
    the bit-packed copies of ``binaries`` and ``skip_grid``.
    """

    aabbs: Tensor  # (levels, 6)
    occs: Tensor  # (levels * cells_per_lvl,)
    binaries: Tensor  # (levels, rx, ry, rz) bool
    binaries_packed: Tensor  # (levels, rx, ry, ceil(rz/32)) int32
    skip_grid: Tensor  # (levels, rx/f, ry/f, rz/f) bool
    skip_packed: Tensor  # (levels, rx/f, ry/f, ceil(rz/f/32)) int32

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
        self._resolution_cache: Dict[torch.device, Tensor] = {}

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
        copies (a stale skip grid or packed grid would answer for the old
        occupancy)."""
        binaries = binaries.to(device=state.binaries.device, dtype=torch.bool)
        return state.replace(**self._grids(binaries))

    def _grids(self, binaries: Tensor) -> dict:
        """``binaries`` with its skip grid and the packed copies of both."""
        assert binaries.shape == (self.levels,) + self.resolution
        skip_grid = build_skip_grid(binaries, self.skip_factor)
        return dict(
            binaries=binaries,
            binaries_packed=bitpack_grid(binaries),
            skip_grid=skip_grid,
            skip_packed=bitpack_grid(skip_grid),
        )

    # ------------------------------------------------------------------
    def plan_traversal(
        self,
        render_step_size: float,
        cone_angle: float = 0.0,
        near_plane: float = 0.0,
        max_samples_per_ray: Optional[int] = None,
        max_macro_segments: int = 24,
        has_skip_grid: bool = True,
    ):
        """Static traversal shape: ``(lattice, use_skip, macro_stride,
        max_macro, row_cap)``, as ``occ_grid.py:160-210`` plans it.

        On the uniform ladder ``macro_stride`` keeps a macro span under two
        skip cells, so the midpoint probe on the dilated skip grid stays
        conservative; the geometric (cone) ladder takes stride 16 and four
        probes, and macro-skip is off for ``cone_angle > skip_factor /
        (2 * res)``, where four probes would no longer be conservative.
        """
        lattice = num_ladder_steps(
            self.max_t_range, render_step_size, cone_angle, near=near_plane
        )
        use_skip = has_skip_grid
        if cone_angle > self.skip_factor / (2.0 * max(self.resolution)):
            use_skip = False
        if use_skip and cone_angle <= 0.0:
            cell0 = float((self.roi_aabb[3] - self.roi_aabb[0]) / self.resolution[0])
            macro_stride = int(2 * self.skip_factor * cell0 / render_step_size)
            macro_stride = max(4, min(64, macro_stride))
        else:
            macro_stride = 16
        if use_skip:
            max_macro = min(max_macro_segments, -(-lattice // macro_stride))
            row_cap = max_samples_per_ray or (max_macro * macro_stride)
            row_cap = min(row_cap, max_macro * macro_stride)
        else:
            max_macro = 16
            row_cap = max_samples_per_ray or lattice
        return lattice, use_skip, macro_stride, max_macro, row_cap

    # ------------------------------------------------------------------
    def sampling(
        self,
        state: OccGridState,
        rays_o: Tensor,
        rays_d: Tensor,
        sigma_fn: Optional[Callable] = None,
        alpha_fn: Optional[Callable] = None,
        early_stop_eps: float = 1e-4,
        alpha_thre: float = 0.0,
        return_extras: bool = False,
        **kwargs,
    ):
        """Sample along rays with empty-space skipping (``occ_grid.py:213-354``).

        Returns flat arrays of fixed length ``(ray_indices, t_starts, t_ends,
        is_valid)``, compacted and sorted by ray; ``kwargs`` are those of
        :meth:`compact_samples` (``near_plane``, ``t_min``, ``t_max``, ...).
        With ``sigma_fn`` or ``alpha_fn`` (called as ``fn(t_starts, t_ends,
        ray_indices)``) and ``alpha_thre > 0`` or ``early_stop_eps > 0``,
        samples whose transmittance is below ``early_stop_eps`` or whose
        alpha is below ``min(alpha_thre, mean(state.occs))`` are dropped:
        ``is_valid`` False and ``t_ends = t_starts``.  ``return_extras`` adds
        a dict with ``macro_truncated`` and ``macro_truncated_frac``.  Not
        differentiable.
        """
        cs = self.compact_samples(state, rays_o, rays_d, **kwargs)
        t_starts, t_ends, is_valid, ray_indices = cs.t_starts, cs.t_ends, cs.kept, cs.ray_indices
        if (alpha_thre > 0.0 or early_stop_eps > 0.0) and (
            sigma_fn is not None or alpha_fn is not None
        ):
            with torch.no_grad():
                # The raw mean, -1 cells included, as the JAX package takes it.
                thre = state.occs.mean().clamp(max=alpha_thre)
                if sigma_fn is not None:
                    sigmas = torch.where(is_valid, sigma_fn(t_starts, t_ends, ray_indices), 0.0)
                    masks = render_visibility_from_density(
                        t_starts, t_ends, sigmas, ray_indices=ray_indices,
                        early_stop_eps=early_stop_eps, alpha_thre=thre,
                    )
                else:
                    alphas = torch.where(is_valid, alpha_fn(t_starts, t_ends, ray_indices), 0.0)
                    masks = render_visibility_from_alpha(
                        alphas, ray_indices=ray_indices,
                        early_stop_eps=early_stop_eps, alpha_thre=thre,
                    )
            is_valid = is_valid & masks
            t_ends = torch.where(is_valid, t_ends, t_starts)
        out = (ray_indices, t_starts, t_ends, is_valid)
        if return_extras:
            extras = {
                "macro_truncated": cs.macro_truncated,
                "macro_truncated_frac": cs.macro_truncated.float().mean(),
            }
            return out + (extras,)
        return out

    def compact_samples(
        self,
        state: OccGridState,
        rays_o: Tensor,
        rays_d: Tensor,
        near_plane: float = 0.0,
        far_plane: float = 1e10,
        t_min: Optional[Tensor] = None,
        t_max: Optional[Tensor] = None,
        render_step_size: float = 1e-3,
        stratified: bool = False,
        cone_angle: float = 0.0,
        jitter: Optional[Tensor] = None,
        generator: Optional[torch.Generator] = None,
        max_samples: Optional[int] = None,
        sample_capacity: Optional[int] = None,
        max_macro_segments: int = 24,
        use_macro_skip: bool = True,
        carry_rays: bool = False,
    ) -> CompactSamples:
        """Traversal planned by :meth:`plan_traversal` and compacted by
        :func:`~nerfacc_tpu_torch.grid.traverse_and_compact`, for
        :meth:`sampling` and the training renderer.

        The flat length is ``sample_capacity`` if given, else ``n_rays *
        row_cap``, ``row_cap`` the per-ray budget (``max_samples``).  With
        ``stratified``, each ray's near plane moves by ``jitter *
        render_step_size``, where ``jitter`` is an ``(n_rays,)`` tensor in
        ``[0, 1)`` or is drawn from ``generator``.  ``carry_rays`` adds each
        slot's ray components (``CompactSamples.ray_comps``).
        """
        n_rays = rays_o.shape[0]
        near_planes = torch.full((n_rays,), near_plane, dtype=rays_o.dtype, device=rays_o.device)
        far_planes = torch.full((n_rays,), far_plane, dtype=rays_o.dtype, device=rays_o.device)
        if t_min is not None:
            near_planes = torch.maximum(near_planes, t_min)
        if t_max is not None:
            far_planes = torch.minimum(far_planes, t_max)
        if stratified:
            if jitter is None:
                jitter = uniform_draws((n_rays,), generator, rays_o.device)
            near_planes = near_planes + jitter.to(rays_o.dtype) * render_step_size

        lattice, use_skip, macro_stride, max_macro, row_cap = self.plan_traversal(
            render_step_size,
            cone_angle,
            near_plane,
            max_samples_per_ray=max_samples,
            max_macro_segments=max_macro_segments,
            has_skip_grid=use_macro_skip,
        )
        return traverse_and_compact(
            rays_o,
            rays_d,
            state.binaries,
            state.aabbs,
            sample_capacity or (n_rays * row_cap),
            near_planes=near_planes,
            far_planes=far_planes,
            step_size=render_step_size,
            cone_angle=cone_angle,
            traverse_steps_limit=row_cap,
            max_lattice_steps=lattice,
            base_aabb=state.aabbs[0],
            skip_grid=state.skip_grid if use_skip else None,
            packed_skip=state.skip_packed if use_skip else None,
            macro_stride=macro_stride,
            max_macro_segments=max_macro,
            packed_grids=state.binaries_packed,
            carry_rays=carry_rays,
        )

    # ------------------------------------------------------------------
    def update_every_n_steps(
        self,
        state: OccGridState,
        step: int,
        occ_eval_fn: Callable,
        occ_thre: float = 1e-2,
        ema_decay: float = 0.95,
        warmup_steps: int = 256,
        n: int = 16,
        **kwargs,
    ) -> OccGridState:
        """EMA update every ``n`` steps (``occ_grid.py:357-385``); ``step`` is
        a host int, and ``kwargs`` go to :meth:`_update`."""
        if step % n == 0:
            return self._update(
                state, step, occ_eval_fn, occ_thre=occ_thre, ema_decay=ema_decay,
                warmup_steps=warmup_steps, **kwargs,
            )
        return state

    def make_draws(
        self,
        step: int,
        generator: Optional[torch.Generator] = None,
        warmup_steps: int = 256,
        draw_mode: str = "sysrow",
        device: Union[str, torch.device] = "cuda",
    ) -> List[Dict[str, Tensor]]:
        """The random draws of one :meth:`_update`, one dict per level.

        ``jitter`` ``(n, 3)`` in ``[0, 1)``: the probe's place inside its cell.
        :meth:`_update` also takes it as a tuple of three ``(n,)`` tensors,
        one an axis, the layout in which the JAX package draws it for
        ``soa_positions`` (``fold_in(k_jit, c)`` per component).
        After warmup, ``uniform`` ``(cells/4,)`` int64: the uniform half of the
        probed cells; ``offset`` (a scalar in ``[0, 1)``, ``sys``/``sysrow``)
        or ``unit`` (``(cells/4,)`` in ``[0, 1)``, ``uniform``; a caller may
        give ``ranks`` in ``[0, occupied)`` instead): the draw over occupied
        cells.
        """
        device = resolve_device(device)
        n_cells = self.cells_per_lvl // 4
        draws = []
        for _ in range(self.levels):
            d = {}
            if step >= warmup_steps:
                d["uniform"] = torch.randint(
                    0, self.cells_per_lvl, (n_cells,), generator=generator,
                    device=_generator_device(generator, device),
                ).to(device)
                if draw_mode == "uniform":
                    d["unit"] = uniform_draws((n_cells,), generator, device)
                else:
                    d["offset"] = uniform_draws((), generator, device)
            n = self.cells_per_lvl if step < warmup_steps else 2 * n_cells
            d["jitter"] = uniform_draws((n, 3), generator, device)
            draws.append(d)
        return draws

    @torch.no_grad()
    def _update(
        self,
        state: OccGridState,
        step: int,
        occ_eval_fn: Callable,
        occ_thre: float = 1e-2,
        ema_decay: float = 0.95,
        warmup_steps: int = 256,
        draws: Optional[Sequence[Dict[str, Tensor]]] = None,
        generator: Optional[torch.Generator] = None,
        draw_mode: str = "sysrow",
        soa_positions: bool = False,
    ) -> OccGridState:
        """One EMA update (``occ_grid.py:387-657``).

        Warmup (``step < warmup_steps``) probes every cell of every level.
        After it, each level probes a quarter of its cells uniformly and a
        quarter from its occupied cells: ``sysrow`` (the default) takes rows
        of 128 ranks of the sorted occupied list at a fixed stride from one
        random offset, ``sys`` single ranks that way, ``uniform`` random
        ranks.  Where the cells of a level are not a multiple of 512, the
        rows of ``sysrow`` do not tile the draw and ``sys`` is taken instead
        (the JAX package fails there).  ``draws`` (see :meth:`make_draws`)
        default to draws from ``generator``.

        ``soa_positions`` hands ``occ_eval_fn`` the probe positions as an
        ``(xs, ys, zs)`` tuple of ``(n,)`` tensors instead of one ``(n, 3)``
        tensor (``occ_grid.py:396-400,569-590``), each component computed
        as the array form computes it, so both probe the same points given
        the same jitter.

        The EMA max over the probes goes through kernel K3
        (:func:`~nerfacc_tpu_torch.ops.table_grad.cell_max`) at ``>= 2^19``
        draws per level when the cell count is a multiple of 32768 (the JAX
        package's ``auto`` rule), else through ``scatter_reduce``.  Cells at
        ``-1`` (camera-invisible) stay there.
        """
        device = state.occs.device
        if draws is None:
            draws = self.make_draws(step, generator, warmup_steps, draw_mode, device)
        resolution = self._resolution_tensor(device)
        cells = self.cells_per_lvl
        occs = state.occs
        n_total = int(occs.shape[0])
        ry, rz = self.resolution[1], self.resolution[2]

        for lvl in range(self.levels):
            d = draws[lvl]
            if step < warmup_steps:
                indices = torch.arange(cells, device=device)
            else:
                indices = torch.cat(
                    [d["uniform"].to(device), self._occupied_draw(state, lvl, d, draw_mode)]
                )
            comps = [indices // (ry * rz), (indices // rz) % ry, indices % rz]
            aabb = state.aabbs[lvl]
            jit = d["jitter"]
            if soa_positions:
                jit = jit if isinstance(jit, (tuple, list)) else jit.unbind(-1)
                x = tuple(
                    aabb[c] + (comps[c].to(torch.float32) + jit[c].to(device)) / resolution[c]
                    * (aabb[3 + c] - aabb[c])
                    for c in range(3)
                )
            else:
                jit = torch.stack(list(jit), dim=-1) if isinstance(jit, (tuple, list)) else jit
                coords = torch.stack(comps, dim=-1).to(torch.float32)
                x = (coords + jit.to(device)) / resolution
                x = aabb[:3] + x * (aabb[3:] - aabb[:3])
            occ = occ_eval_fn(x).reshape(-1).to(torch.float32)

            cell_ids = lvl * cells + indices
            if indices.shape[0] >= _CELL_MAX_MIN_DRAWS and n_total % 32768 == 0:
                proposed = cell_max(cell_ids.to(torch.int32), occ.contiguous(), n_total)
            else:
                proposed = torch.full_like(occs, -1.0).scatter_reduce_(
                    0, cell_ids, occ, reduce="amax"
                )
            # -1 marks untouched cells (the probes are non-negative).
            touched = (proposed >= 0.0) & (occs >= 0.0)
            occs = torch.where(
                touched, torch.maximum(occs * ema_decay, proposed.clamp(min=0.0)), occs
            )

        visible = occs >= 0.0
        mean_occ = torch.where(visible, occs, 0.0).sum() / visible.sum().clamp(min=1)
        thre = torch.clamp(mean_occ, max=occ_thre)
        binaries = (occs > thre).reshape(state.binaries.shape)
        return state.replace(occs=occs, **self._grids(binaries))

    @torch.no_grad()
    def mark_invisible_cells(
        self,
        state: OccGridState,
        K: Tensor,  # (N, 3, 3) or (1, 3, 3)
        c2w: Tensor,  # (N, 3, 4) or (N, 4, 4)
        width: int,
        height: int,
        near_plane: float = 0.0,
        chunk: int = 32**3,
    ) -> OccGridState:
        """Set ``occs`` to -1 in cells outside every camera's frustum and to 0
        in the rest (``occ_grid.py:660-725``).  Cells go through the cameras
        in chunks of ``chunk``, so that the ``(cameras, 3, chunk)``
        projections stay small with many cameras; ``K`` and ``c2w`` are
        moved to the state's device.  :meth:`_update` never raises a -1
        cell again."""
        device = state.occs.device
        K = torch.as_tensor(K, dtype=torch.float32).to(device)
        c2w = torch.as_tensor(c2w, dtype=torch.float32).to(device)
        assert K.ndim == 3 and K.shape[1:] == (3, 3)
        assert c2w.ndim == 3 and c2w.shape[1] in (3, 4)
        w2c_R = c2w[:, :3, :3].transpose(1, 2)  # (N, 3, 3)
        w2c_T = -w2c_R @ c2w[:, :3, 3:]  # (N, 3, 1)
        ry, rz = self.resolution[1], self.resolution[2]
        res_minus1 = torch.tensor(
            [r - 1 for r in self.resolution], dtype=torch.float32, device=device
        )
        cells = self.cells_per_lvl
        occs = state.occs.clone()
        for lvl in range(self.levels):
            aabb = state.aabbs[lvl]
            for lo in range(0, cells, chunk):
                idx = torch.arange(lo, min(lo + chunk, cells), device=device)
                coords = torch.stack([idx // (ry * rz), (idx // rz) % ry, idx % rz], dim=-1)
                x = coords.to(torch.float32) / res_minus1  # (chunk, 3) in [0, 1]
                xyzs_w = (aabb[:3] + x * (aabb[3:] - aabb[:3])).T  # (3, chunk)
                uvd = K @ (w2c_R @ xyzs_w + w2c_T)  # (N, 3, chunk)
                uv = uvd[:, :2] / uvd[:, 2:]
                in_image = (
                    (uvd[:, 2] >= 0)
                    & (uv[:, 0] >= 0) & (uv[:, 0] < width)
                    & (uv[:, 1] >= 0) & (uv[:, 1] < height)
                )
                covered = ((uvd[:, 2] >= near_plane) & in_image).any(dim=0)
                too_near = ((uvd[:, 2] < near_plane) & in_image).any(dim=0)
                visible = covered & ~too_near
                occs[lvl * cells + idx] = torch.where(visible, 0.0, -1.0)
        return state.replace(occs=occs)

    def _resolution_tensor(self, device: torch.device) -> Tensor:
        """``(3,)`` float32 resolution on ``device``, made once per device (a
        host-to-device copy per update would wait for the queued work)."""
        if device not in self._resolution_cache:
            self._resolution_cache[device] = torch.tensor(
                self.resolution, dtype=torch.float32, device=device
            )
        return self._resolution_cache[device]

    def _occupied_draw(self, state: OccGridState, lvl: int, d: Dict[str, Tensor], mode: str) -> Tensor:
        """A quarter of the level's cells drawn from its occupied cells
        (``occ_grid.py:423-555``); the uniform draw where none is occupied."""
        cells = self.cells_per_lvl
        n_cells = cells // 4
        device = state.occs.device
        uniform_idx = d["uniform"].to(device)
        occ_mask = state.binaries[lvl].reshape(-1)
        total = occ_mask.sum()
        arange = torch.arange(cells, device=device)
        # Occupied ids ascending, then the empty ones (as id + cells).
        occupied_cells = torch.sort(torch.where(occ_mask, arange, cells + arange)).values
        if mode == "sysrow" and cells % (4 * _ROW_WIDTH) != 0:
            mode = "sys"
        if mode == "sysrow":
            n_rows = n_cells // _ROW_WIDTH
            total_rows = ((total + _ROW_WIDTH - 1) // _ROW_WIDTH).clamp(min=1)
            q = (
                (torch.arange(n_rows, dtype=torch.float32, device=device) + d["offset"].to(device))
                * (total_rows.to(torch.float32) / n_rows)
            ).to(torch.int64)
            q = torch.minimum(q, total_rows - 1)
            drawn = occupied_cells.view(-1, _ROW_WIDTH)[q].reshape(-1)
            # The last occupied row can hold empty cells (id + cells): decode
            # them to their own cell, an empty probe like the uniform half.
            drawn = torch.where(drawn < cells, drawn, drawn - cells)
        elif mode == "sys":
            n_occ = total.clamp(min=1)
            u = (
                (torch.arange(n_cells, dtype=torch.float32, device=device) + d["offset"].to(device))
                * (n_occ.to(torch.float32) / n_cells)
            ).to(torch.int64)
            # float32 rank rounding can land exactly on the count.
            drawn = occupied_cells[torch.minimum(u, n_occ - 1)]
        elif mode == "uniform":
            n_occ = total.clamp(min=1)
            if "ranks" in d:  # ranks drawn in [0, n_occ) by the caller
                u = d["ranks"].to(device=device, dtype=torch.int64)
            else:
                u = (d["unit"].to(device) * n_occ).to(torch.int64)
            drawn = occupied_cells[torch.minimum(u, n_occ - 1)]
        else:
            raise ValueError(f"unknown draw_mode {mode!r}")
        return torch.where(total > 0, drawn, uniform_idx)


def _generator_device(generator: Optional[torch.Generator], device) -> torch.device:
    return torch.device("cpu") if generator is None else generator.device


def uniform_draws(shape, generator: Optional[torch.Generator], device) -> Tensor:
    """Float32 draws in ``[0, 1)`` from ``generator`` (or the global one),
    made on the generator's device and moved to ``device``."""
    return torch.rand(
        shape, generator=generator, device=_generator_device(generator, device)
    ).to(device)
