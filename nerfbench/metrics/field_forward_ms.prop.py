"""Device ms a step of the kernels launched under the program's
``field_forward`` range (the radiance field's forward pass)."""

from nerfbench.metrics_common import range_per_step


def read(ctx):
    return range_per_step(ctx, "field_forward")
