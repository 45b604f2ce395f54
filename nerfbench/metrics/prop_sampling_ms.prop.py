"""Device ms a step of the kernels launched under the program's
``prop_sampling`` range (the proposal net and the resampling)."""

from nerfbench.metrics_common import range_per_step


def read(ctx):
    return range_per_step(ctx, "prop_sampling")
