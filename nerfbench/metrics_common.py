"""Arithmetic the per-layer readers share.  A reader gets ``ctx``: the
trace of the slice (``trace``, a :class:`~nerfbench.traceread.TraceStats`),
its ``steps`` and occupancy ``updates``, the chip's ``peaks``, and the
untraced window's ``window_s`` and counts (``window_steps``,
``window_rays``, ``window_flops``, ...); it returns None where the cell
gives it nothing to read.

The profiler slows the host, so the traced slice's wall time is longer
than the same steps take untraced; shares of time are taken against the
untraced window."""

from __future__ import annotations

from typing import Optional


def range_per_step(ctx: dict, name: str) -> Optional[float]:
    trace = ctx.get("trace")
    ms = None if trace is None else trace.device_ms(name)
    return None if ms is None else ms / ctx["steps"]


def range_per_update(ctx: dict, name: str) -> Optional[float]:
    trace = ctx.get("trace")
    ms = None if trace is None or not ctx.get("updates") else trace.device_ms(name)
    return None if ms is None else ms / ctx["updates"]


def window_mfu(ctx: dict) -> Optional[float]:
    """Per cent of the float32 peak that the window's model FLOPs reach
    over the window's time."""
    flops, secs = ctx.get("window_flops"), ctx.get("window_s")
    if not flops or not secs:
        return None
    return 100.0 * flops / secs / ctx["peaks"]["float32_flops"]


def idle_share(ctx: dict) -> Optional[float]:
    """Per cent of an untraced step in which the card is idle: one minus
    the traced slice's device-busy time a step over the wall time a step
    of the window's last segments (the same regime: past warm-up, whole
    update cycles, the slice following them)."""
    trace, step_s = ctx.get("trace"), ctx.get("late_step_s")
    if trace is None or not step_s or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - (trace.busy_s / ctx["steps"]) / step_s)
