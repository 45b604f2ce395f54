"""Kept samples over rays in the timed window, from the sample counts that
the training loop returns for each step."""


def read(ctx):
    if ctx.get("window_samples") is None or not ctx.get("window_rays"):
        return None
    return ctx["window_samples"] / ctx["window_rays"]
