"""Hand-written CUDA kernels with their plain PyTorch versions."""

from .occ_query import (
    bitpack_grid,
    occupancy_query,
    occupancy_query_plain,
)
from .table_grad import (
    cell_max,
    cell_max_plain,
    hash_lookup_combine,
    hash_lookup_combine3,
    hash_lookup_combine_pos,
    hash_table_lookup_sized,
    table_grad_pos,
    table_grad_pos_plain,
    table_grad_sorted,
    table_grad_sorted_plain,
    table_grad_u10,
    table_grad_u10_plain,
    table_grad_w3,
    table_grad_w3_plain,
    table_grad_w8,
    table_grad_w8_plain,
)

__all__ = [
    "bitpack_grid",
    "cell_max",
    "cell_max_plain",
    "hash_lookup_combine",
    "hash_lookup_combine3",
    "hash_lookup_combine_pos",
    "hash_table_lookup_sized",
    "occupancy_query",
    "occupancy_query_plain",
    "table_grad_pos",
    "table_grad_pos_plain",
    "table_grad_sorted",
    "table_grad_sorted_plain",
    "table_grad_u10",
    "table_grad_u10_plain",
    "table_grad_w3",
    "table_grad_w3_plain",
    "table_grad_w8",
    "table_grad_w8_plain",
]
