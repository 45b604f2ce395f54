"""Reduction of a ``torch.profiler`` Chrome trace to per-layer numbers.

A device event (kernel, memcpy, memset) belongs to a range when the host
call that launched it (the runtime event of the same ``correlation``) lies
inside a ``record_function`` span of that name on the same host thread.
Autograd's backward launches from its own thread, outside every range of
the caller, so its kernels are "unattributed", as are those under torch's
own ``Optimizer.*`` ranges alone.  Only events launched inside the
benchmark's window span count; the busy time is the union of their device
intervals, clipped to the window.  Kernel time by name is summed as
``nerfacc_tpu_torch/scripts/capture_trace.py`` sums it.
"""

from __future__ import annotations

import collections
import gzip
import json
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
WINDOW = "nerfbench.window"
NOT_PROGRAM = ("nerfbench.", "Optimizer.", "ProfilerStep")


def load(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _is_program_range(name: str) -> bool:
    return not name.startswith(NOT_PROGRAM)


class TraceStats:
    """Per-range device time, host span time and the busy share of the
    events inside the window span ``WINDOW``."""

    def __init__(self, events: Iterable[dict]):
        spans: Dict[Tuple, List[Tuple[float, float, str]]] = collections.defaultdict(list)
        launches: Dict[int, Tuple[Tuple, float]] = {}
        device: List[dict] = []
        window: Optional[Tuple[float, float]] = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            if cat == "user_annotation":
                if e["name"] == WINDOW:
                    window = (ts, ts + dur)
                spans[(e.get("pid"), e.get("tid"))].append((ts, ts + dur, e["name"]))
            elif cat in HOST_LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
                launches[e["args"]["correlation"]] = ((e.get("pid"), e.get("tid")), ts)
            elif cat in DEVICE_CATEGORIES:
                device.append(e)
        if window is None:
            raise ValueError(f"the trace has no {WINDOW!r} span")
        self.window = window
        self.spans = spans
        # Each launch's enclosing span names: a sweep over each thread's
        # spans and launches in time order.
        by_thread: Dict[Tuple, List[Tuple[float, int]]] = collections.defaultdict(list)
        for corr, (thread, ts) in launches.items():
            if window[0] <= ts <= window[1]:
                by_thread[thread].append((ts, corr))
        names_of: Dict[int, frozenset] = {}
        for thread, ls in by_thread.items():
            sp = sorted(spans.get(thread, ()))
            active: List[Tuple[float, float, str]] = []
            i = 0
            for ts, corr in sorted(ls):
                while i < len(sp) and sp[i][0] <= ts:
                    active.append(sp[i])
                    i += 1
                active = [a for a in active if a[1] >= ts]
                names_of[corr] = frozenset(n for _, _, n in active)
        self.kernels: List[Tuple[float, float, str, frozenset]] = []
        for e in device:
            corr = e.get("args", {}).get("correlation")
            if corr not in names_of:
                continue
            ts = float(e["ts"])
            self.kernels.append((ts, ts + float(e.get("dur", 0.0)), e["name"], names_of[corr]))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        """The union of the device intervals inside the window, in seconds."""
        lo, hi = self.window
        busy, end = 0.0, lo
        for s, t, _, _ in sorted(self.kernels):
            s, t = max(s, end), min(t, hi)
            if t > s:
                busy += t - s
                end = t
        return busy * 1e-6

    def device_ms(self, range_name: str) -> Optional[float]:
        """Device ms of the events launched under ``range_name``; None
        where no such span was opened in the window."""
        if not self.has_span(range_name):
            return None
        return sum(t - s for s, t, _, names in self.kernels if range_name in names) * 1e-3

    def unattributed_ms(self) -> float:
        return sum(t - s for s, t, _, names in self.kernels
                   if not any(_is_program_range(n) for n in names)) * 1e-3

    def host_ms(self, range_name: str) -> Optional[float]:
        """Host ms inside spans named ``range_name`` within the window."""
        lo, hi = self.window
        total, found = 0.0, False
        for thread_spans in self.spans.values():
            for s, t, n in thread_spans:
                if n == range_name and lo <= s and t <= hi:
                    total += t - s
                    found = True
        return total * 1e-3 if found else None

    def has_span(self, range_name: str) -> bool:
        lo, hi = self.window
        return any(n == range_name and lo <= s <= hi for sp in self.spans.values() for s, _, n in sp)

    def top_kernels(self, k: int = 10) -> List[Tuple[str, float]]:
        agg = collections.Counter()
        for s, t, name, _ in self.kernels:
            agg[name] += (t - s) * 1e-6
        return [[n, v] for n, v in agg.most_common(k)]

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """The longest stretches of the window with no device event, each
        named by the innermost program range the host was in at its start
        (the host thread that launched the most events)."""
        lo, hi = self.window
        gaps, end = [], lo
        for s, t, _, _ in sorted(self.kernels):
            if s > end:
                gaps.append((end, s))
            end = max(end, t)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        main = max(self.spans, key=lambda th: sum(1 for *_, n in self.spans[th] if _is_program_range(n)), default=None)
        out = []
        for a, b in gaps[:k]:
            inner = [(t - s, n) for s, t, n in self.spans.get(main, ()) if s <= a <= t and _is_program_range(n)]
            label = min(inner)[1] if inner else "outside the program's ranges"
            out.append([label, (b - a) * 1e-6])
        return out
