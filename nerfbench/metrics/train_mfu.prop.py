"""Per cent of the card's float32 peak (outside the tensor cores) that the
untraced window's model FLOPs (:mod:`nerfbench.flops`) reach over the
window's wall time: every field sample trained, every proposal sample
trained where the cadence trains the proposal net, else evaluated."""

from nerfbench.metrics_common import window_mfu


def read(ctx):
    return window_mfu(ctx)
