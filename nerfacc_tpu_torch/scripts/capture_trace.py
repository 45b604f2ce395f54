"""Device trace of the NGP-occ train step: capture it with
``torch.profiler`` and print each kernel's time a step.

Port of ``scripts/capture_trace.py``.  :mod:`.run_profiler` times whole
stages; this script records the card's own timeline for a few train steps
(with ``--occ-update``, and one occupancy update after them) at
``bench.py``'s configuration (the occupancy shell on a res-128 grid, the
fused encoder L4 x F16 with 2^18 entries, bf16, 16384 rays, 2^19 slots),
writes it as a Chrome trace and sums its kernels by name: :func:`parse`,
which also reads a trace written before (``--parse-only``).

    python -m nerfacc_tpu_torch.scripts.capture_trace                 # on the card
    python -m nerfacc_tpu_torch.scripts.capture_trace --occ-update --top 40
    python -m nerfacc_tpu_torch.scripts.capture_trace --parse-only build/torch-trace
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os

# Chrome-trace categories of torch.profiler's device events; everything
# else (cpu_op, python_function, cuda_runtime, user_annotation and the
# gpu_user_annotation spans of record_function ranges) is host time or a
# label.
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def parse(trace_dir: str, top: int, steps: int) -> dict:
    """Each device event name's total ms a step in the newest Chrome trace
    under ``trace_dir``, printed largest first (the first ``top``); returns
    the whole table."""
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True) + glob.glob(
        os.path.join(trace_dir, "**", "*.json.gz"), recursive=True)
    if not paths:
        print(f"no trace found under {trace_dir}")
        return {}
    path = max(paths, key=os.path.getmtime)
    print(f"trace: {path}")
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    agg = collections.Counter()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            agg[e["name"]] += float(e.get("dur", 0.0))
    total = sum(agg.values())
    print(f"total device kernel time: {total / 1e3 / steps:.2f} ms/step")
    for name, us in agg.most_common(top):
        print(f"{us / 1e3 / steps:8.3f} ms  {name[:110]}")
    return {name: us / 1e3 / steps for name, us in agg.items()}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--rays", type=int, default=16384)
    p.add_argument("--capacity", type=int, default=1 << 19)
    p.add_argument("--grid_res", type=int, default=128)
    p.add_argument("--levels", type=int, default=4)
    p.add_argument("--log2t", type=int, default=18)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--out", type=str, default="build/torch-trace")
    p.add_argument("--dtype", type=str, default="bf16", choices=["f32", "bf16"])
    p.add_argument("--parse-only", type=str, default=None, help="skip the capture; parse a trace directory")
    p.add_argument("--occ-update", action="store_true", help="trace one occupancy update after the steps")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.parse_only:
        return parse(args.parse_only, args.top, args.steps)

    import numpy as np
    import torch

    from ..device import resolve_device
    from ..estimators.occ_grid import OccGridEstimator
    from ..models.ngp import NGPRadianceField
    from ..rendering import gather_ray_od, occgrid_render_rays
    from ..utils.profiler import trace

    dev = resolve_device(args.device)
    aabb = [-1.5] * 3 + [1.5] * 3
    res, step_size = args.grid_res, 5e-3
    est = OccGridEstimator(roi_aabb=aabb, resolution=res, levels=1, skip_factor=2)
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    shell = np.abs(np.sqrt(gx**2 + gy**2 + gz**2) - 0.45) < 0.08
    state = est.set_binaries(est.init(dev), torch.from_numpy(shell[None]))
    field = NGPRadianceField(
        aabb=aabb, n_levels=args.levels, n_features_per_level=16, log2_hashmap_size=args.log2t,
        compute_dtype=torch.bfloat16 if args.dtype == "bf16" else None, device=dev,
        generator=torch.Generator().manual_seed(0),
    )
    opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(args.rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = (torch.from_numpy(a).to(dev) for a in (-3.0 * d, d))
    pixels = torch.from_numpy(rng.random((args.rays, 3), dtype=np.float32)).to(dev)
    bkgd = torch.ones(3, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rgb_sigma_fn(ts, te, ri):
        o, dd = gather_ray_od(rays_o, rays_d, ri)
        rgb, s = field(o + ((ts + te) / 2)[:, None] * dd, dd)
        return rgb, s[..., 0]

    def train_step():
        jitter = torch.rand((args.rays,), generator=gen, device=dev)
        c, _, _, _, _ = occgrid_render_rays(
            rgb_sigma_fn, None, est, state, rays_o, rays_d, near_plane=0.0, far_plane=1e10,
            render_step_size=step_size, render_bkgd=bkgd, stratified=True, jitter=jitter,
            sample_capacity=args.capacity, max_macro_segments=4,
        )
        loss = torch.nn.functional.huber_loss(c, pixels, delta=1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    def occ_update():
        with torch.no_grad():
            est._update(state, 10**9, lambda x: field.query_density(x) * step_size, generator=gen)

    for _ in range(3):
        train_step()
    if args.occ_update:
        occ_update()
    with trace(args.out):
        for _ in range(args.steps):
            train_step()
        if args.occ_update:
            occ_update()
    return parse(args.out, args.top, args.steps)


if __name__ == "__main__":
    main()
