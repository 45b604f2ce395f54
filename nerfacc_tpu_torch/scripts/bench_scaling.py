"""Rays/s of the data-parallel train step against the number of ranks.

Port of ``scripts/bench_scaling.py``.  For each world size it starts that
many local processes, each one rank joined by
:func:`~nerfacc_tpu_torch.parallel.initialize_distributed` (``--backend``,
NCCL by default), runs
:func:`~nerfacc_tpu_torch.parallel.make_parallel_train_step` at
``--rays-per-dev`` rays a rank (each rank loads only its own rays) and
prints rays/s per world size and the efficiency against the first one, as
one JSON line.  The configuration is the JAX script's: a fully occupied
res-32 grid over +-1, the L4 hash field with 2^13 rows, 8192 sample slots
a rank, step 2e-2 from 0.5 to 4, Adam 1e-2, a ``(2, n/2)`` hybrid layout
at even world sizes.

Each rank takes card ``rank % device_count``, so only world sizes up to
the number of cards measure a speed; on a machine with one card that is a
world of one.  More ranks than cards share a card, which NCCL refuses:
the script refuses them too unless it is given ``--backend gloo
--allow-shared-card``, and then the rays/s of the shared card are a
correctness run, not scaling.

    python -m nerfacc_tpu_torch.scripts.bench_scaling --worlds 1
    python -m nerfacc_tpu_torch.scripts.bench_scaling --device cpu --backend gloo --worlds 1,2,4
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--worlds", default="1", help="comma-separated world sizes (default: 1)")
    p.add_argument("--rays-per-dev", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--backend", default="nccl", choices=["nccl", "gloo"])
    p.add_argument("--allow-shared-card", action="store_true",
                   help="with --backend gloo: run more ranks than cards, sharing them (a correctness run)")
    p.add_argument("--worker", nargs=3, type=int, metavar=("RANK", "WORLD", "PORT"), help=argparse.SUPPRESS)
    return p.parse_args(argv)


def run_rank(args, rank: int, world: int, port: int) -> float:
    """One rank: join, build the step, time ``--iters`` steps; rays/s over
    the world."""
    from ..estimators.occ_grid import OccGridEstimator
    from ..models.ngp import NGPRadianceField
    from ..parallel import (
        host_local_rays_to_global, initialize_distributed, make_hybrid_mesh, make_parallel_train_step,
        process_local_batch_size, replicate,
    )

    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    initialize_distributed(f"127.0.0.1:{port}", world, rank, backend=args.backend)
    mesh = make_hybrid_mesh(hosts=2 if world > 1 and world % 2 == 0 else 1, device=args.device)
    dev = mesh.device
    est = OccGridEstimator(AABB, 32, 1)
    state = replicate(est.set_binaries(est.init(dev), torch.ones((1, 32, 32, 32), dtype=torch.bool)), mesh)
    field = NGPRadianceField(aabb=AABB, n_levels=4, log2_hashmap_size=13, max_resolution=128, device=dev,
                             generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(field.parameters(), lr=1e-2)
    replicate(field, mesh)
    step = make_parallel_train_step(field, est, opt, mesh, render_step_size=2e-2, near_plane=0.5, far_plane=4.0,
                                    sample_capacity_per_shard=8192)
    n_rays = args.rays_per_dev * world
    local = process_local_batch_size(n_rays)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pixels = rng.random((n_rays, 3), dtype=np.float32)
    own = slice(mesh.index * local, (mesh.index + 1) * local)
    rays_o, rays_d, px = host_local_rays_to_global(mesh, (-2.0 * d[own], d[own], pixels[own]))
    bkgd = torch.ones(3, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(3):
        step(state, rays_o, rays_d, px, bkgd)
    sync()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        loss, _ = step(state, rays_o, rays_d, px, bkgd)
    float(loss)  # waits for the last step
    sync()
    return n_rays * args.iters / (time.perf_counter() - t0)


def main(argv=None) -> dict:
    """Prints and returns ``{"metric": "scaling_rays_per_sec", "rows": [...]}``."""
    args = parse_args(argv)
    if args.worker:
        rank, world, port = args.worker
        rays_s = run_rank(args, rank, world, port)
        if rank == 0:
            print("RESULT", world, rays_s, flush=True)
        return {}
    from ..device import resolve_device

    worlds = [int(x) for x in args.worlds.split(",")]
    if resolve_device(args.device).type == "cuda":
        cards = torch.cuda.device_count()
        if max(worlds) > cards and not (args.backend == "gloo" and args.allow_shared_card):
            raise SystemExit(
                f"{max(worlds)} ranks but {cards} card(s): ranks would share a card, which NCCL refuses; "
                "pass --backend gloo --allow-shared-card for a correctness run"
            )
    results = {}
    root = Path(__file__).resolve().parents[2]
    for world in worlds:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, "-m", "nerfacc_tpu_torch.scripts.bench_scaling", "--rays-per-dev",
               str(args.rays_per_dev), "--iters", str(args.iters), "--device", args.device, "--backend",
               args.backend]
        procs = [subprocess.Popen(cmd + ["--worker", str(r), str(world), str(port)], cwd=root,
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for r in range(world)]
        outs = []
        try:
            outs = [p.communicate(timeout=1200) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for line in outs[0][0].splitlines() if outs else []:
            if line.startswith("RESULT"):
                results[world] = float(line.split()[2])
        if world not in results:
            err = "\n".join(o[1][-2000:] for o in outs)
            print(f"world size {world} FAILED:\n{err}", file=sys.stderr)
    base = results.get(worlds[0])
    rows = [
        {"world": w, "rays_per_sec": results[w],
         "efficiency_vs_linear": results[w] / (base * w / worlds[0]) if base else float("nan")}
        for w in worlds if w in results
    ]
    out = {"metric": "scaling_rays_per_sec", "device": args.device, "backend": args.backend, "rows": rows}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
