"""Timing and tracing helpers.

Port of ``nerfacc_tpu/utils/profiler.py``: :func:`time_jitted` warms a
function up and times it (the name is the JAX package's, whose function
jits first; here the call runs as it is), and :func:`trace` records a
``torch.profiler`` trace of the host and, where there is a card, of its
kernels, written as a Chrome trace (``scripts/capture_trace.py`` sums its
kernels).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch

__all__ = ["time_jitted", "trace"]


def _on_cuda(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_cuda(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_cuda(v) for v in out)
    return False


def _wait(out) -> None:
    """Wait for the card where ``out`` holds a CUDA tensor."""
    if _on_cuda(out):
        torch.cuda.synchronize()


def time_jitted(
    fn: Callable,
    *args,
    warmup: int = 3,
    iters: int = 20,
    name: Optional[str] = None,
) -> float:
    """``warmup`` calls of ``fn(*args)``, then ``iters`` timed calls with
    one wait for the card at the end (no host read in between).  Returns
    seconds a call."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait(out)
    dt = (time.perf_counter() - t0) / iters
    if name:
        print(f"{name}: {dt * 1e3:.3f} ms/iter")
    return dt


@contextlib.contextmanager
def trace(logdir: str = "build/torch-trace"):
    """Record a ``torch.profiler`` trace of the block (CPU activity, and
    CUDA activity where there is a card) and write it to
    ``<logdir>/trace.json`` (Chrome trace format).  Yields ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield logdir
        if cuda:
            torch.cuda.synchronize()  # the block's kernels end inside the trace
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path}")
