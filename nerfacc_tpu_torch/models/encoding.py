"""The tcnn-parity hash-grid encoding and the view-direction encoding.

Port of ``nerfacc_tpu/models/encoding.py``: :class:`HashGridEncoder`, the
multiresolution hash encoding of Instant-NGP with tiny-cuda-nn's exact
parametrisation (one ``(L * T, F)`` table, one row a grid vertex), and the
degree-4 spherical harmonics.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from .hash_soa import TcnnHashGrid

Tensor = torch.Tensor


class HashGridEncoder(TcnnHashGrid):
    """Multiresolution hash encoding (``encoding.py:29-125``), tcnn's
    ``(L * T, F)`` table: one row a grid vertex.  The levels, the vertex
    rule, the initialisation and the table gradient are
    :class:`~nerfacc_tpu_torch.models.hash_soa.TcnnHashGrid`'s."""

    def __init__(
        self,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        max_resolution: int = 4096,
        *,
        device: Union[str, torch.device] = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__(
            n_levels, n_features_per_level, log2_hashmap_size, base_resolution, max_resolution,
            False, device, generator,
        )


def spherical_harmonics_deg4(d: Tensor) -> Tensor:
    """Real SH basis up to degree 4 (16 coefficients), tcnn's
    ``SphericalHarmonics`` view encoding.  ``d``: ``(..., 3)`` unit
    directions; returns ``(..., 16)``."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack(
        [
            torch.full_like(x, 0.28209479177387814),  # l0
            -0.48860251190291987 * y,  # l1
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,  # l2
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),  # l3
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=-1,
    )
