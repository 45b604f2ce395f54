"""Model FLOPs from the configuration's shapes, and the chip's peaks.

One field evaluation costs the hash encoding's trilinear combine (a
multiply-add per corner, feature and level: ``2 * 8 * L * F``) and two
FLOPs per weight of every MLP layer it runs.  A training sample costs three
evaluations (forward, and the backward's two products); recomputation is
not counted.  The peak is the float32 rate outside the tensor cores, since
the configurations compute in float32 with TF32 off.
"""

from __future__ import annotations

from .reference.field import mlp_layers

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
PEAKS = {"float32_flops": 67e12}


def encoding_flops(field: dict) -> int:
    enc = field["encoding"]
    return 2 * 8 * enc["n_levels"] * enc["n_features_per_level"]


def field_flops(field: dict, colour: bool = True) -> int:
    """FLOPs of one evaluation at one point: the density (and features),
    and with ``colour`` the head MLP too."""
    total = encoding_flops(field)
    for prefix, widths in mlp_layers(field).items():
        if colour or prefix == "mlp_base":
            total += sum(2 * a * b for a, b in zip(widths[:-1], widths[1:]))
    return total


TRAIN_FACTOR = 3


def update_points(steps, every: int, warmup_steps: int, cells: int) -> int:
    """Points an occupancy grid probes over ``steps``: an update every
    ``every`` steps, every cell during warm-up, half the cells after."""
    return sum(cells if s < warmup_steps else cells // 2 for s in steps if s % every == 0)
