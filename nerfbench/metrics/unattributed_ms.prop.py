"""Device ms a step of the kernels launched under none of the program's
ranges: autograd's backward (field, rendering and table gradients),
which runs on its own thread, and where the loop names no optimizer
range, Adam."""


def read(ctx):
    trace = ctx.get("trace")
    return None if trace is None else trace.unattributed_ms() / ctx["steps"]
