"""Run one cell of the benchmark once.

    python3 -m nerfbench.run --workload ngp_occ.train --seed 7 --seconds 50 --trace 0

Loads the cell's configuration and traffic mix (found by name, see
:mod:`nerfbench.registry`), builds the program's objects from seeded
weights, trains the checked first steps, warms up, measures for
``--seconds`` (``--trace 1``: then traces a fixed slice of steps and reads
the per-layer metrics), evaluates off the clock, frees the program, runs
the plain reference over the checked steps (and over what the pipeline
checks past the window) and prints one JSON line: the
end-to-end metrics (``--trace 0``) or the per-layer ones (``--trace 1``),
``correct`` and the compared numbers beside their limits.  It needs an
NVIDIA card and never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nerfacc_tpu")
# Few host threads, and none that spin: the loader's OpenMP sampler
# otherwise keeps about four cores busy waiting between its short parallel
# regions, and the training loop's own thread then runs slower by an amount
# that varies from run to run.  Set before torch and the sampler start.
HOST_THREADS = {"OMP_NUM_THREADS": "2", "OMP_WAIT_POLICY": "PASSIVE"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name only begins with it)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_counters() -> dict:
    """The process's CPU seconds and, where the cgroup shows them, its
    throttled microseconds (read only)."""
    out = {"cpu_s": sum(os.times()[:2])}
    try:
        with open("/sys/fs/cgroup/cpu.stat") as f:
            for line in f:
                key, _, value = line.partition(" ")
                if key in ("throttled_usec", "nr_throttled"):
                    out[key] = int(value)
    except OSError:
        pass
    return out


def measure(cell, seconds: float, device):
    """Segments of the cell's work until ``seconds`` have passed; returns
    ``(work units, seconds)``, the window ending in a synchronize (a
    segment may return its units as a tensor on the device, read after
    the window).  Prints the host's CPU use over the window to standard
    error."""
    sync(device)
    before = host_counters()
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < seconds:
        done += cell.segment()
    sync(device)
    elapsed = time.perf_counter() - t0
    after = host_counters()
    print("nerfbench: window host use: " + ", ".join(f"{k} {after[k] - before[k]:.6g}" for k in after),
          file=sys.stderr, flush=True)
    return float(done), elapsed


def traced(cell, steps: int, device) -> tuple:
    """The cell's trace slice under ``torch.profiler``: ``(TraceStats,
    slice info)``; the trace is written under ``TMPDIR`` and removed."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from .traceread import WINDOW, TraceStats, load

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with tempfile.TemporaryDirectory(prefix="nerfbench-trace-") as tmp:
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                info = cell.trace_slice(steps)
                sync(device)
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        stats = TraceStats(load(path))
    return stats, info


class Stages:
    """Prints each stage's seconds to standard error; returns the time
    since ``t_start``."""

    def __init__(self, t_start: float):
        self.t_start = self.last = t_start

    def __call__(self, name: str) -> float:
        now = time.perf_counter()
        print(f"nerfbench: {name}: {now - self.last:.3f} s", file=sys.stderr, flush=True)
        self.last = now
        return now - self.t_start


def run_cell(bench, wl: dict, seed: int, seconds: float, trace: int, device, t_start: float) -> dict:
    """One run of cell ``wl`` on ``device``: the result line as a dict."""
    import torch

    from .flops import PEAKS
    from .registry import pipeline

    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    limits = bench.limits(wl["name"])["limits"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["allow_tf32"]

    stage = Stages(t_start)
    cell = pipeline(cfg["pipeline"], bench.root).Cell(cfg, traffic, seed, device)
    stage("build (imports, views, program objects)")
    cell.setup()
    sync(device)
    setup_s = stage("checked steps and warm-up")

    work, window_s = measure(cell, seconds, device)
    ctx = dict(config=cfg, peaks=PEAKS, window_s=window_s, **cell.window_context())
    cell.after_window()
    stats = None
    if trace:
        stats, info = traced(cell, traffic["trace_steps"], device)
        ctx.update(info, trace=stats)
    stage("window, the step after it, trace")
    psnr = cell.evaluate()
    sync(device)
    stage("eval")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    attempted, failed = cell.attempted, cell.failed
    cell.release()
    readings = cell.reference()
    stage("reference")

    checks = {k: {"value": readings[k], "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0 and math.isfinite(psnr)
    metrics = {}
    if trace:
        for m in bench.metrics("per_layer", wl["name"]):
            value = bench.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        # A metric's quantity is named by its name up to the first dot
        # (``train_samples_per_s.occ`` is the rate of the occupancy cell).
        e2e = {"setup_s": setup_s, cell.work_metric: work / window_s, "eval_psnr_db": psnr}
        for m in bench.metrics("end_to_end", wl["name"]):
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]], "unit": m["unit"]}
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind, "count": wl["chips"],
           "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if stats is not None:
        dev.update(busy_s=stats.busy_s, window_s=stats.window_s)
        result["breakdown"] = {"device_ops": stats.top_kernels(10), "idle_gaps": stats.idle_gaps(10)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    os.environ.update(HOST_THREADS)
    args = parse_args(argv)
    from .registry import Benchmark

    bench = Benchmark(Path.cwd())
    wl = bench.workload(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"nerfbench: {args.workload} needs {wl['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(bench, wl, args.seed, args.seconds, args.trace, device, T_START)
    found = forbidden_modules()
    if found:
        print(f"nerfbench: the process loaded {found}; the port may not load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
