"""Device ms a step of the kernels launched under the program's
``optimizer`` range (Adam over the field's parameters, hash table
included)."""

from nerfbench.metrics_common import range_per_step


def read(ctx):
    return range_per_step(ctx, "optimizer")
