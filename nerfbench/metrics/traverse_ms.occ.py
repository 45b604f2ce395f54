"""Device ms a step of the kernels launched under the program's
``traverse_and_compact`` range (the occupancy estimator: the traversal, K1,
the compaction)."""

from nerfbench.metrics_common import range_per_step


def read(ctx):
    return range_per_step(ctx, "traverse_and_compact")
