"""Per cent of the card's float32 peak (outside the tensor cores) that the
untraced window's model FLOPs (:mod:`nerfbench.flops`) reach over the
window's wall time: every kept sample trained, every sample of the
visibility filter's density pass, every probe of the updates."""

from nerfbench.metrics_common import window_mfu


def read(ctx):
    return window_mfu(ctx)
