"""Readings that the limits of a training cell's comparison are set from:
the program's checked steps against the reference on many seeds (sound),
with the control switched on (TF32), and with each planted fault, in one
process on the card at the cell's own size.  The benchmark's own runs do
not run this.

    python3 -m nerfbench.calibrate --workload ngp_occ.train --seeds 101-112 \\
        --control-seeds 201-203 --fault-seeds 301-303 --steps 640 --out calib_occ.jsonl

Each line of ``--out`` (and of standard output) is one reading: the
workload, the mode (``sound``, ``tf32``, or a fault's name), the seed and
the compared numbers.  Training's readings need no timed window: after the
checked steps the cell trains on to ``--steps`` (in the window's
segments, untimed) before what it checks past the window.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import torch

from . import faults
from .registry import Benchmark, pipeline


def seed_list(text: str) -> list:
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def reading(bench: Benchmark, workload: str, seed: int, mode: str, device, views=None, steps: int = 0):
    """The compared numbers of one seed's run of ``steps`` steps under
    ``mode``; returns ``(numbers, views, per-leaf detail)``."""
    wl = bench.workload(workload)
    cfg = bench.config(wl["config"])
    traffic = bench.traffic(wl["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = cfg["allow_tf32"]
    patch = {**faults.FAULTS, **faults.CONTROL}.get(mode, contextlib.nullcontext)
    cell = pipeline(cfg["pipeline"], bench.root).Cell(cfg, traffic, seed, device, views=views)
    with patch():
        cell.setup()
        while cell.step < steps:
            cell.segment()
        cell.window_context()
        cell.after_window()
    cell.release()
    out = cell.reference()
    detail, views = cell.detail, cell.views
    del cell
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out, views, detail


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--faults", default="half_batch,altered")
    p.add_argument("--steps", type=int, default=0, help="steps to train before what is checked past the window")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("nerfbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = Benchmark(Path.cwd())
    plan = [("sound", s) for s in seed_list(args.seeds)]
    plan += [("tf32", s) for s in seed_list(args.control_seeds)]
    plan += [(f, s) for f in filter(None, args.faults.split(",")) for s in seed_list(args.fault_seeds)]
    views = None
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    sink = open(args.out, "a") if args.out else None
    try:
        for mode, seed in plan:
            t = time.perf_counter()
            numbers, views, detail = reading(bench, args.workload, seed, mode, device, views, args.steps)
            line = json.dumps(dict(workload=args.workload, mode=mode, seed=seed, seconds=time.perf_counter() - t,
                                   **numbers, detail=detail))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
