"""Host ms a step inside the program's ``fetch`` range (the loader's
training batch: the native sampler and the copy to the card)."""


def read(ctx):
    trace = ctx.get("trace")
    ms = None if trace is None else trace.host_ms("fetch")
    return None if ms is None else ms / ctx["steps"]
