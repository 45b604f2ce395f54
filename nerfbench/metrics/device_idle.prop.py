"""Per cent of an untraced step in which no kernel, copy or set runs on
the card: the traced slice's device-busy time a step against the wall time
a step of the window's last 16 segments, untraced."""

from nerfbench.metrics_common import idle_share


def read(ctx):
    return idle_share(ctx)
