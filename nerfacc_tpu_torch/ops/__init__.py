"""Hand-written CUDA kernels with their plain PyTorch versions."""

from .occ_query import (
    bitpack_grid,
    occupancy_query,
    occupancy_query_plain,
)

__all__ = [
    "bitpack_grid",
    "occupancy_query",
    "occupancy_query_plain",
]
