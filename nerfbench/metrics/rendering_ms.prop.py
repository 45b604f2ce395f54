"""Device ms a step of the kernels launched under the program's
``rendering`` range (volume rendering, forward)."""

from nerfbench.metrics_common import range_per_step


def read(ctx):
    return range_per_step(ctx, "rendering")
