"""Device ms an occupancy update of the kernels launched under the
program's ``occ_update`` range (the draw, the density probes, K3)."""

from nerfbench.metrics_common import range_per_update


def read(ctx):
    return range_per_update(ctx, "occ_update")
