"""Device ms a step of the kernels launched under the program's
``visibility`` range (the occupancy estimator's visibility filter: a
density pass without gradients over the traversal's samples, the
transmittance test and the refilter's compaction)."""

from nerfbench.metrics_common import range_per_step


def read(ctx):
    return range_per_step(ctx, "visibility")
