"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
1. card: name and power limit; build every kernel from ``nerfacc_tpu_torch/csrc``.
2. kernel K1 (occupancy query) against its plain PyTorch version on the
   card, for exact equality, at the render shape and on adversarial points;
   timings with CUDA events.
3. serve: render one 800x800 view at the full-width configuration
   (``examples/render.py`` with the synthetic block of
   ``examples/train_ngp_nerf_occ.py``), random weights from seed 0, the
   occupancy shell of ``bench.py``; K1 must be launched on that path.
   Then every 8th chunk again, once plain and once under torch.profiler:
   where the device time goes and how long the device sits idle.
4. card against CPU: a 64x64 crop of the same view through the port on the
   card and on the CPU, with the same weights.
5. kernels K2 (table gradient, bf16), K4-w3 (table gradient, float32) and
   K3 (per-cell max) against their plain versions on the card, at the
   training shapes; timings beside each kernel's bound.
6. train: the NGP-occ train step of ``bench.py:59-294`` at its full width
   (16384 rays, 2^19 samples, bf16 compute), 3 warm-up steps, 30 timed
   steps and 8 timed occupancy updates; samples/s, step and update ms, the
   launches of K1, K2 and K3 on that path, peak memory, first and last loss;
   K1 against its plain version on one step's skip probes and lattice
   queries; then a few steps under torch.profiler.
7. card against CPU: the traversal of 1024 rays at 2^15 and 2^17 slots
   (every field), then one train step and one occupancy update at 1024 rays
   and 2^15 samples, full field width, same weights, jitter and draws: the
   kept samples and the grid must agree, and at float32 (K4-w3) and bf16
   (K2) the loss, the table gradient and the parameters after Adam.
The last two lines are the kernel table and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

# Configuration (examples/render.py + train_ngp_nerf_occ.py synthetic block).
AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
GRID_RES = 128
STEP = 5e-3
FIELD_CFG = dict(
    n_levels=8, n_features_per_level=16, log2_hashmap_size=18,
    mlp_width=64, geo_feat_dim=15,
)
RENDER_KW = dict(
    max_samples=1024, samples_per_round=32, near_plane=0.0, far_plane=1e10,
    render_step_size=STEP, cone_angle=0.0, alpha_thre=0.0,
)
CHUNK = 4096
# bench.py's train configuration (throughput phase).
TRAIN_FIELD_CFG = dict(
    n_levels=4, n_features_per_level=16, log2_hashmap_size=18,
    mlp_width=64, geo_feat_dim=15,
)
TRAIN_RAYS, TRAIN_CAPACITY, TRAIN_MACRO = 16384, 1 << 19, 4
TRAIN_ITERS, TRAIN_UPDATES = 30, 8
WIDTH = HEIGHT = 800
FOCAL = 0.5 * WIDTH / math.tan(0.5 * 0.6911112070083618)  # lego's camera_angle_x
CROP = 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_OPS_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, calls: int = 20, reps: int = 15) -> float:
    """Device time of one ``fn()``: ``calls`` calls are captured in a CUDA
    graph, and the graph is replayed ``reps`` times between CUDA events; the
    median replay over ``calls``.  The graph leaves out the host's time to
    enqueue (a ctypes call and the wrapper's checks take longer than K1 runs
    at the render shape).  The inputs stay in L2 from one call to the next,
    as they do on the render path, where the traversal has just written them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def shell_binaries(res: int) -> np.ndarray:
    """bench.py's converged-like occupancy: a shell of ~8% of the cells."""
    g = (np.arange(res) + 0.5) / res * 2 - 1
    gx, gy, gz = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(gx**2 + gy**2 + gz**2)
    return (np.abs(r - 0.45) < 0.08)[None]


def adversarial_points(aabb: np.ndarray, levels: int, res: int, rng) -> np.ndarray:
    """Points on cell faces of every level, at +-0.5 of the normalised box,
    outside it, in z cells that are the last bit of a word, and at random."""
    lo, ext = aabb[:3], aabb[3:] - aabb[:3]
    faces = []
    for lvl in range(levels):
        k = np.arange(res + 1, dtype=np.float32) / res - 0.5  # level-0 faces
        faces.append(k * 2.0**lvl)
    faces = np.concatenate(faces)
    special = np.array([-0.5, 0.5, -0.5000001, 0.4999999, 0.0], np.float32)
    z31 = ((np.arange(31, res, 32) + 0.5) / res - 0.5).astype(np.float32)
    coords = np.concatenate([faces, special, z31])
    n_side = coords.shape[0]
    grid = np.stack(np.meshgrid(coords[: min(n_side, 96)], coords, z31, indexing="ij"), -1)
    pts = [grid.reshape(-1, 3)]
    pick = rng.integers(0, n_side, size=(200_000, 3))
    pts.append(coords[pick])
    scale = 2.0 ** (levels + 1)
    pts.append(rng.uniform(-scale, scale, size=(200_000, 3)).astype(np.float32))
    nrm = np.concatenate(pts).astype(np.float32)
    return (lo + (nrm + 0.5) * ext).astype(np.float32)


def profile_window(run, stages, what: str, out_name: str) -> None:
    """Where the time of ``run()`` goes: time it without the profiler, then
    trace it with torch.profiler.  Prints the device's busy and idle share
    (kernel time over the untraced wall time), kernel time by stage (the
    ``record_function`` ranges named in ``stages``; each kernel goes to the
    innermost range whose span on the GPU timeline holds it, the rest to
    "unattributed"), and the top kernels.  The full table goes to
    ``chiprun_out/<out_name>``."""
    import bisect
    import itertools
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_traced = time.perf_counter() - t0

    events = prof.events()
    # GPU-side spans of the record_function ranges, and the real device work.
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in events if e.device_type == DeviceType.CUDA and e.name in stages
    )
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and e.name not in stages]
    if not kernels:
        fail(f"profile {what}: the profiler recorded no device activity")
    starts = [sp[0] for sp in spans]
    reach = list(itertools.accumulate((sp[1] for sp in spans), max))  # latest end so far
    other = "unattributed"
    per_stage = dict.fromkeys(tuple(stages) + (other,), 0.0)
    by_kernel = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        t = e.time_range.start
        name = other
        # The innermost span holding the kernel: the latest start before it
        # whose span has not ended.
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if reach[i] <= t:
                break
            if t < spans[i][1]:
                name = spans[i][2]
                break
        per_stage[name] += us / 1e3
        ms, count = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (ms + us / 1e3, count + 1)
    host = dict.fromkeys(stages, 0.0)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in stages:
            host[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(per_stage.values()) / 1e3
    print(
        f"profile {what}: {wall:.3f} s untraced, {wall_traced:.3f} s traced; device busy "
        f"{busy:.3f} s = {100 * busy / wall:.1f}% of the untraced time, "
        f"idle {100 * (1 - busy / wall):.1f}%",
        flush=True,
    )
    for name, ms in per_stage.items():
        extra = f", host {host[name]:.1f} ms traced" if name in host else ""
        print(f"profile stage {name}: device {ms:.1f} ms "
              f"({100 * ms / (busy * 1e3):.1f}% of device time){extra}", flush=True)
    for name, (ms, count) in sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"profile kernel {ms:9.1f} ms {count:6d}x {name[:100]}", flush=True)
    out = Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / out_name).write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    )


def kernel_row(name, source, replaces, launches, err, ms, plain_ms, nbytes, ops, library_ms):
    """One entry of the kernel table; the bound is the larger of the bytes
    over the card's memory rate and the float32 operations over its rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_OPS_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(b_ms, o_ms), "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": library_ms,
    }


def train_step(field, opt, est, state, rays_o, rays_d, pixels, jitter, capacity):
    """One step of bench.py's train loop: render, Huber loss, backward, Adam.
    Returns the loss and the kept-sample count, both on the device."""
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays
    from torch.profiler import record_function

    def rgb_sigma_fn(ts, te, ri):
        o, d = gather_ray_od(rays_o, rays_d, ri)
        rgb, sigma = field(o + ((ts + te) / 2)[:, None] * d, d)
        return rgb, sigma[..., 0]

    colors, _, _, n_samp, _ = occgrid_render_rays(
        rgb_sigma_fn, None, est, state, rays_o, rays_d,
        near_plane=0.0, far_plane=1e10, render_step_size=STEP,
        render_bkgd=torch.ones(3, device=rays_o.device), stratified=True, jitter=jitter,
        sample_capacity=capacity, max_macro_segments=TRAIN_MACRO,
    )
    loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
    opt.zero_grad(set_to_none=True)
    with record_function("backward"):
        loss.backward()
    with record_function("optimizer"):
        opt.step()
    return loss.detach(), n_samp


def occ_update(est, state, field, **draw_kw):
    """bench.py's occupancy update (post-warmup draws, 2^20 at res 128)."""
    from torch.profiler import record_function

    with record_function("occ_update"):
        return est._update(
            state, 10**9, lambda x: field.query_density(x) * STEP, **draw_kw
        )


def k1_on_train_inputs(step, state) -> float:
    """K1 against its plain version on the queries that one train step gives
    it: the macro-skip probes on ``state.skip_packed`` (``mip_pad=1``) and
    the lattice queries on ``state.binaries_packed``, recorded as
    ``traverse_and_compact`` makes them.  Exact, and equal to ``_query_soa``
    on the unpacked grid.  Returns the largest difference."""
    import nerfacc_tpu_torch.grid as grid_mod
    from nerfacc_tpu_torch.ops.occ_query import _query_soa, occupancy_query, occupancy_query_plain

    calls = []

    def recording(packed, aabb, px, py, pz, rz, mip_pad=0):
        calls.append((packed, aabb, (px, py, pz), rz, mip_pad))
        return occupancy_query(packed, aabb, px, py, pz, rz=rz, mip_pad=mip_pad)

    grid_mod.occupancy_query = recording
    try:
        step()
    finally:
        grid_mod.occupancy_query = occupancy_query
    unpacked = {id(state.skip_packed): state.skip_grid, id(state.binaries_packed): state.binaries}
    kinds, err = set(), 0.0
    for packed, aabb, pts, rz, mip_pad in calls:
        if id(packed) not in unpacked:
            fail("K1 on the train path: a query on a grid that is neither skip_packed nor binaries_packed")
        label = "skip_packed" if packed is state.skip_packed else "binaries_packed"
        kinds.add((label, mip_pad))
        out = occupancy_query(packed, aabb, *pts, rz=rz, mip_pad=mip_pad)
        plain = occupancy_query_plain(packed, aabb, *pts, rz=rz, mip_pad=mip_pad)
        ref, _ = _query_soa(*pts, unpacked[id(packed)], aabb, mip_pad=mip_pad)
        torch.cuda.synchronize()
        bad = int((out != plain).sum()) + int((out != ref).sum())
        err = max(err, float((out.float() - plain.float()).abs().max()))
        print(f"K1 train path, {label} mip_pad={mip_pad}: queries {tuple(pts[0].shape)}, "
              f"{int(out.sum())} occupied, {bad} mismatches", flush=True)
        if bad:
            fail(f"K1 disagrees with its plain version on {bad} train-path queries ({label})")
    if kinds != {("skip_packed", 1), ("binaries_packed", 0)}:
        fail(f"K1 on the train path: expected skip probes and lattice queries, saw {sorted(kinds)}")
    return err


def traversal_card_vs_cpu(est, shell, rays_o, rays_d, jitter, dev) -> None:
    """The train step's traversal on the card and on the CPU, every field of
    the ``CompactSamples``: at 2^15 slots, which 1024 rays overfill (72
    samples a ray), and at 2^17, above the demand, so that the kept count is
    free to differ.  Integer and bool fields exact; the float fields (t
    values, planes) within 1e-6 of the largest finite value, the same
    non-finite entries."""
    cpu = torch.device("cpu")
    for capacity in (1 << 15, 1 << 17):
        res = []
        for device in (dev, cpu):
            state = est.set_binaries(est.init(device), shell)
            cs = est.compact_samples(
                state, rays_o.to(device), rays_d.to(device), near_plane=0.0, far_plane=1e10,
                render_step_size=STEP, stratified=True, jitter=jitter.to(device),
                sample_capacity=capacity, max_macro_segments=TRAIN_MACRO,
            )
            res.append({k: v.cpu() for k, v in cs._asdict().items()})
        a, b = res  # card, CPU
        t_err = 0.0
        for k, want in b.items():
            got = a[k]
            if not want.is_floating_point():
                if not torch.equal(got, want):
                    fail(f"card vs CPU traversal at capacity {capacity}: {k} differs "
                         f"in {int((got != want).sum())} entries")
                continue
            fin = torch.isfinite(want)
            if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(got[~fin], want[~fin]):
                fail(f"card vs CPU traversal at capacity {capacity}: {k} differs in its non-finite entries")
            scale = float(want[fin].abs().max()) if bool(fin.any()) else 0.0
            k_err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
            t_err = max(t_err, k_err)
            if k_err > 1e-6 * scale:
                fail(f"card vs CPU traversal at capacity {capacity}: {k} max abs err {k_err} > 1e-6 * {scale}")
        print(f"card vs CPU traversal at capacity {capacity}: kept {int(a['kept'].sum())} = "
              f"{int(b['kept'].sum())}, integer fields equal, t max abs err {t_err:.3e}", flush=True)


def kernels_vs_plain(dev) -> dict:
    """Phase 5: K2, K4-w3 and K3 against their plain versions at the
    training shapes, and their times."""
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderFused
    from nerfacc_tpu_torch.ops.table_grad import (
        cell_max,
        cell_max_plain,
        quantize_u10,
        table_grad_u10,
        table_grad_u10_plain,
        table_grad_w3,
        table_grad_w3_plain,
    )

    rng = np.random.default_rng(1)
    # Sample points as the train path meets them: around bench.py's
    # occupancy shell, in the field's [0, 1] box, through the bench
    # encoder's rows (4 levels of 2^15 rows; the coarsest, 16^3 cells, is
    # indexed densely, so a quarter of the samples pile onto 4096 rows).
    n = TRAIN_CAPACITY
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radius = 0.225 * (1.0 + rng.uniform(-0.18, 0.18, size=(n, 1)))
    u = torch.from_numpy((0.5 + radius * dirs).astype(np.float32)).to(dev)
    enc = HashGridEncoderFused(
        n_levels=4, n_features_per_level=16, log2_hashmap_size=15, device=dev
    )
    rows, (wx, wy, wz) = enc.cell_indices(u)
    n_rows = enc.table.shape[0]
    idx = rows.reshape(-1).to(torch.int32)
    wx, wy, wz = (w.reshape(-1).contiguous() for w in (wx, wy, wz))
    n_sl = idx.numel()
    sorted_idx, perm = torch.sort(idx)
    wq = quantize_u10(wx, wy, wz)
    dout = torch.from_numpy(
        (rng.standard_normal((n_sl, 16)) * 1e-3).astype(np.float32)
    ).to(dev)
    dout_bf = dout.to(torch.bfloat16)
    rows_hit = int((torch.bincount(idx[: n_sl // 4].long(), minlength=4096) > 0).sum())
    untouched = torch.bincount(idx.long(), minlength=n_rows) == 0
    print(f"K2/K4 inputs: {n_sl} sample-levels over {n_rows} rows, level 0 on {rows_hit} rows", flush=True)

    out = {}
    for label, kern, plain, args in (
        ("K2", table_grad_u10, table_grad_u10_plain, (sorted_idx, perm, wq, dout_bf, n_rows)),
        ("K4-w3", table_grad_w3, table_grad_w3_plain, (sorted_idx, perm, wx, wy, wz, dout, n_rows)),
    ):
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        # atol 1e-5 of the largest row sum: the same terms summed in
        # float32 in another order.
        print(f"{label}: max abs err {err:.3e} against plain (largest row sum {scale:.3e})", flush=True)
        if not err <= 1e-5 * scale:
            fail(f"{label} disagrees with its plain version: {err} > 1e-5 * {scale}")
        if bool(got[untouched].any()):
            fail(f"{label} wrote rows that no sample names")
        out[label] = dict(
            err=err, ms=time_ms(lambda: kern(*args)), plain_ms=time_ms(lambda: plain(*args), calls=5)
        )
    sort_ms = time_ms(lambda: torch.sort(idx))
    out["K2"]["bytes"] = n_sl * (4 + 4 + 2 * 16) + n_rows * 128 * 4
    out["K4-w3"]["bytes"] = n_sl * (4 + 3 * 4 + 4 * 16) + n_rows * 128 * 4
    for label in ("K2", "K4-w3"):
        out[label]["ops"] = n_sl * 8 * 16 * 2  # a multiply and an add per term
        o = out[label]
        print(
            f"{label} at {n_sl} sample-levels: kernel {o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, "
            f"bound {o['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms ({o['bytes']} B at 3.35 TB/s)",
            flush=True,
        )
    print(f"torch.sort of {n_sl} int32 rows (outside K2, K4): {sort_ms:.4f} ms", flush=True)

    # K3 at bench.py's update: 2^20 draws into 2^21 cells, half uniform and
    # half from the occupied shell (so cells repeat), values in [0, 4e-3]
    # with a cluster at 1e-3, where the TPU kernel's precision trap was.
    n_cells, n_draws = 1 << 21, 1 << 20
    occupied = np.flatnonzero(shell_binaries(128).reshape(-1))
    ids = np.concatenate([
        rng.integers(0, n_cells, n_draws // 2), occupied[rng.integers(0, occupied.size, n_draws // 2)]
    ]).astype(np.int32)
    vals = rng.random(n_draws, dtype=np.float32) * 4e-3
    vals[:4096] = (1e-3 * (1.0 + rng.uniform(-1e-6, 1e-6, 4096))).astype(np.float32)
    ids_t, vals_t = torch.from_numpy(ids).to(dev), torch.from_numpy(vals).to(dev)
    got = cell_max(ids_t, vals_t, n_cells)
    plain = cell_max_plain(ids_t, vals_t, n_cells)

    def library():
        return torch.full((n_cells,), -1.0, device=dev).scatter_reduce_(0, ids_t.long(), vals_t, "amax")

    lib = library()
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    print(f"K3: {int((got >= 0).sum())} cells touched, max abs err {err} against plain, "
          f"equal to scatter_reduce(amax): {torch.equal(got, lib)}", flush=True)
    if not (torch.equal(got, plain) and torch.equal(got, lib)):
        fail("K3 is not exact against its plain version and scatter_reduce(amax)")
    ids_long = ids_t.long()
    out["K3"] = dict(
        err=err, ms=time_ms(lambda: cell_max(ids_t, vals_t, n_cells)),
        plain_ms=time_ms(lambda: cell_max_plain(ids_t, vals_t, n_cells)),
        library_ms=time_ms(lambda: torch.full((n_cells,), -1.0, device=dev).scatter_reduce_(
            0, ids_long, vals_t, "amax")),
        bytes=n_draws * 8 + n_cells * 4, ops=n_draws,
    )
    o = out["K3"]
    print(
        f"K3 at {n_draws} draws: kernel {o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, "
        f"scatter_reduce {o['library_ms']:.4f} ms, bound {o['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms",
        flush=True,
    )
    return out


def train_full_width(dev):
    """Phase 6: bench.py's throughput phase on the port, then K1 against its
    plain version on one step's queries.  Returns the field (for phase 7),
    the launches of K1, K2 and K3 on the train path and K1's largest
    difference on those queries."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField
    from nerfacc_tpu_torch.ops.occ_query import occupancy_query
    from nerfacc_tpu_torch.ops.table_grad import cell_max, table_grad_u10

    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1, skip_factor=2)
    state = est.set_binaries(est.init(dev), torch.from_numpy(shell_binaries(GRID_RES)))
    field = NGPRadianceField(
        aabb=AABB, compute_dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(0), **TRAIN_FIELD_CFG,
    )
    opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
    rng = np.random.default_rng(0)  # bench.py:86,118-122
    d = rng.normal(size=(TRAIN_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = torch.from_numpy(-3.0 * d).to(dev)
    rays_d = torch.from_numpy(d).to(dev)
    pixels = torch.from_numpy(rng.random((TRAIN_RAYS, 3), dtype=np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        jitter = torch.rand((TRAIN_RAYS,), generator=gen, device=dev)
        return train_step(field, opt, est, state, rays_o, rays_d, pixels, jitter, TRAIN_CAPACITY)

    def update():
        return occ_update(est, state, field, generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    occupancy_query.launches = table_grad_u10.launches = cell_max.launches = 0
    losses = []
    for _ in range(3):  # warm-up
        losses.append(step()[0])
    update()
    torch.cuda.synchronize()
    # Dispatch the whole window; read the sample counts after the clock stops.
    t0 = time.perf_counter()
    n_samps = []
    for _ in range(TRAIN_ITERS):
        loss, n_samp = step()
        losses.append(loss)
        n_samps.append(n_samp)
    torch.cuda.synchronize()
    step_time = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = [update() for _ in range(TRAIN_UPDATES)]
    torch.cuda.synchronize()
    update_time = (time.perf_counter() - t0) / TRAIN_UPDATES
    launches = dict(K1=occupancy_query.launches, K2=table_grad_u10.launches, K3=cell_max.launches)
    total = int(torch.stack(n_samps).sum())
    occupied = int(outs[-1].binaries.sum())
    del outs
    # bench.py: one occupancy update per 16 steps.
    sps = total / (step_time + TRAIN_ITERS / 16.0 * update_time)
    first, last = float(losses[0]), float(losses[-1])
    print(
        f"train: {sps:.1f} samples/s ({total} samples in {TRAIN_ITERS} steps), "
        f"step {step_time / TRAIN_ITERS * 1e3:.2f} ms, occupancy update {update_time * 1e3:.2f} ms, "
        f"launches K1 {launches['K1']} K2 {launches['K2']} K3 {launches['K3']}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"loss first {first:.6f} last {last:.6f}, occupied after an update {occupied}",
        flush=True,
    )
    if not all(math.isfinite(float(x)) for x in losses):
        fail("train: a loss is not finite")
    if launches["K1"] <= 0 or launches["K2"] < TRAIN_ITERS or launches["K3"] < TRAIN_UPDATES:
        fail(f"train: kernels launched too few times on the train path: {launches}")
    if not 0.5 * TRAIN_CAPACITY * TRAIN_ITERS < total <= TRAIN_CAPACITY * TRAIN_ITERS:
        fail(f"train: {total} samples in {TRAIN_ITERS} steps is not near the capacity")
    k1_err = k1_on_train_inputs(step, state)

    def steps_and_update():
        for _ in range(3):
            step()
        update()

    profile_window(
        steps_and_update,
        ("traverse_and_compact", "field_forward", "rendering", "backward",
         "table_grad", "optimizer", "occ_update"),
        "train (3 steps and 1 update)", "profile_train.txt",
    )
    return field, launches, k1_err


def train_card_vs_cpu(dev, field_state) -> int:
    """Phase 7: one train step and one occupancy update at 1024 rays and
    2^15 samples, full width, on the card and on the CPU, from the same
    weights, jitter and draws.  Returns K4-w3's launches in the card's
    float32 step."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField
    from nerfacc_tpu_torch.ops.table_grad import table_grad_u10, table_grad_w3

    cpu = torch.device("cpu")
    n_rays, capacity = 1024, 1 << 15
    rng = np.random.default_rng(2)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = torch.from_numpy(-3.0 * d), torch.from_numpy(d)
    pixels = torch.from_numpy(rng.random((n_rays, 3), dtype=np.float32))
    jitter = torch.from_numpy(rng.random(n_rays, dtype=np.float32))
    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1, skip_factor=2)
    draws = est.make_draws(10**9, torch.Generator().manual_seed(3), device=cpu)
    shell = torch.from_numpy(shell_binaries(GRID_RES))
    traversal_card_vs_cpu(est, shell, rays_o, rays_d, jitter, dev)
    w3_launches = 0
    # Tolerances, relative to each parameter's largest gradient: float32,
    # 1e-4 for the table (K4-w3 against its plain version and the same
    # upstream float32 math) and 3e-4 for the MLPs, whose gradients are sums
    # over 32k samples that cancel, so the card's and the CPU's last-bit
    # differences in GEMMs and exp/sigmoid grow relative to the result
    # (9.05e-5 to 1.06e-4 measured); bf16, 2e-2 for all
    # (tests/test_models.py:549).
    for cdt, label, tol, mlp_tol in (
        (None, "float32", 1e-4, 3e-4), (torch.bfloat16, "bf16", 2e-2, 2e-2)
    ):
        res = []
        for device in (dev, cpu):
            field = NGPRadianceField(aabb=AABB, compute_dtype=cdt, device=device, **TRAIN_FIELD_CFG)
            field.load_state_dict({k: v.to(device) for k, v in field_state.items()})
            opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
            state = est.set_binaries(est.init(device), shell)
            counts = table_grad_u10.launches, table_grad_w3.launches
            t0 = time.perf_counter()
            loss, n_samp = train_step(
                field, opt, est, state, rays_o.to(device), rays_d.to(device),
                pixels.to(device), jitter.to(device), capacity,
            )
            grads = {k: p.grad.detach().cpu() for k, p in field.named_parameters()}
            params = {k: p.detach().cpu() for k, p in field.named_parameters()}
            new_state = occ_update(est, state, field, draws=draws) if cdt is None else None
            if device.type == "cuda":
                torch.cuda.synchronize()
                if cdt is None:
                    w3_launches = table_grad_w3.launches - counts[1]
                used = (table_grad_u10.launches - counts[0], table_grad_w3.launches - counts[1])
                if used != ((0, 1) if cdt is None else (1, 0)):
                    fail(f"card vs CPU ({label}): K2, K4-w3 launches {used}")
            res.append(dict(
                loss=float(loss), n=int(n_samp), grads=grads, params=params,
                occs=None if new_state is None else new_state.occs.cpu(),
                binaries=None if new_state is None else new_state.binaries.cpu(),
                s=time.perf_counter() - t0,
            ))
        a, b = res  # card, CPU
        if a["n"] != b["n"]:
            fail(f"card vs CPU ({label}): kept samples {a['n']} vs {b['n']}")
        loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        worst = {}
        for k, g_cpu in b["grads"].items():
            g_gpu = a["grads"][k]
            k_tol = tol if k == "encoder.table" else mlp_tol
            g_tol = k_tol * float(g_cpu.abs().max())
            worst[k] = float((g_gpu - g_cpu).abs().max()) / max(float(g_cpu.abs().max()), 1e-30)
            # Adam's first step moves a parameter by lr * g / (|g| + eps),
            # about lr * sign(g); a sign may differ only where the gradients
            # agree within g_tol, and the step is held where the signs agree
            # and |g| is far above eps = 1e-15.
            agree = torch.sign(g_gpu) == torch.sign(g_cpu)
            held = agree & (g_cpu.abs() > 1e-9)
            p_err = float(torch.where(held, a["params"][k] - b["params"][k], 0.0).abs().max())
            if worst[k] > k_tol or not bool((g_cpu[~agree].abs() <= g_tol).all()) or p_err > 1e-6:
                fail(f"card vs CPU ({label}): {k} gradient rel err {worst[k]:.3e} (tol {k_tol}), "
                     f"params after Adam err {p_err:.3e}")
        print(
            f"card vs CPU train step ({label}, {n_rays} rays, capacity {capacity}): samples "
            f"{a['n']} = {b['n']}, loss {a['loss']:.7f} vs {b['loss']:.7f} (rel err {loss_err:.2e}), "
            f"table gradient rel err {worst['encoder.table']:.2e} (tol {tol}), worst over "
            f"parameters {max(worst.values()):.2e} (tol {mlp_tol}); CPU step {b['s']:.1f} s",
            flush=True,
        )
        if loss_err > tol:
            fail(f"card vs CPU ({label}): loss rel err {loss_err} > {tol}")
        if cdt is None:
            occ = b["occs"]
            thre = min(float(occ[occ >= 0].mean()), 1e-2)
            flips = (a["binaries"] != b["binaries"]).reshape(-1)
            # Densities on the card and the CPU differ in their last bits,
            # so only cells within 1e-5 of the largest value from the
            # threshold may fall on different sides.
            near = (occ - thre).abs() <= 1e-5 * float(occ.max())
            print(f"card vs CPU occupancy update: {int(b['binaries'].sum())} occupied cells, "
                  f"{int(flips.sum())} differ, {int(near.sum())} at the threshold, occs max abs err "
                  f"{float((a['occs'] - occ).abs().max()):.3e}", flush=True)
            if bool((flips & ~near).any()):
                fail("card vs CPU: the occupancy grids differ away from the threshold")
    return w3_launches


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    from nerfacc_tpu_torch.datasets.procedural import pose_spherical
    from nerfacc_tpu_torch.datasets.utils import generate_rays
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.grid import _march_ladder
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField
    from nerfacc_tpu_torch.ops import _build
    from nerfacc_tpu_torch.ops.occ_query import (
        _query_soa,
        bitpack_grid,
        occupancy_query,
        occupancy_query_plain,
    )
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays_test

    # Full float32 products: TF32 would keep about three decimal digits.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(f"card: {card_line}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {_build.kernel_names()}", flush=True)

    # ---- 2. K1 against its plain version -----------------------------------
    rng = np.random.default_rng(0)
    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1)
    state = est.set_binaries(est.init(dev), torch.from_numpy(shell_binaries(GRID_RES)))
    base = state.aabbs[0].contiguous()

    # Render-shaped queries: 4096 rays x a 256-step window, positions as
    # traverse_grids computes them.
    n_q_rays, window = CHUNK, 256
    d = rng.normal(size=(n_q_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = torch.from_numpy(-3.0 * d).to(dev)
    rays_d = torch.from_numpy(d).to(dev)
    near = torch.full((n_q_rays,), 1.8, device=dev)
    edges = _march_ladder(near, window + 1, STEP, 0.0)
    t_mid = (edges[:, :-1] + edges[:, 1:]) * 0.5
    pxyz = [(rays_o[:, i : i + 1] + t_mid * rays_d[:, i : i + 1]).contiguous() for i in range(3)]
    packed, rz = state.binaries_packed, GRID_RES

    mismatches = 0
    k1_max_err = 0.0

    def compare(packed_, data_, aabb_, pts, mip_pad, label):
        nonlocal mismatches, k1_max_err
        out = occupancy_query(packed_, aabb_, *pts, rz=data_.shape[-1], mip_pad=mip_pad)
        plain = occupancy_query_plain(packed_, aabb_, *pts, rz=data_.shape[-1], mip_pad=mip_pad)
        ref, _ = _query_soa(*pts, data_, aabb_, mip_pad=mip_pad)
        torch.cuda.synchronize()
        bad = int((out != plain).sum()) + int((out != ref).sum())
        mismatches += bad
        k1_max_err = max(k1_max_err, float((out.float() - plain.float()).abs().max()))
        print(f"K1 {label}: {out.numel()} queries, {int(out.sum())} occupied, {bad} mismatches", flush=True)

    compare(packed, state.binaries, base, pxyz, 0, "render shape 4096x256")
    for levels, res in ((1, GRID_RES), (4, 32)):
        aabb_np = np.asarray(AABB, np.float32)
        pts = torch.from_numpy(adversarial_points(aabb_np, levels, res, rng)).to(dev)
        pts = [pts[:, i].contiguous() for i in range(3)]
        if levels == 1:
            data = state.binaries
        else:
            data = torch.from_numpy(rng.random((levels, res, res, res)) < 0.3).to(dev)
        for mip_pad in (0, 1):
            compare(bitpack_grid(data), data, base, pts, mip_pad,
                    f"adversarial levels={levels} res={res} mip_pad={mip_pad}")
    if mismatches:
        fail(f"K1 disagrees with its plain version on {mismatches} queries")

    k1_ms = time_ms(lambda: occupancy_query(packed, base, *pxyz, rz=rz))
    k1_plain_ms = time_ms(lambda: occupancy_query_plain(packed, base, *pxyz, rz=rz))
    n_q = pxyz[0].numel()
    k1_bytes = n_q * (3 * 4 + 1) + packed.numel() * 4 + 6 * 4
    k1_ops = n_q * 30  # ~30 float operations per query (normalise, mip, 3 cells)
    k1_bound_bytes_ms = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_bound_ops_ms = k1_ops / F32_OPS_PER_S * 1e3
    k1_bound_ms = max(k1_bound_bytes_ms, k1_bound_ops_ms)
    print(
        f"K1 at {n_q} queries: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
        f"bound {k1_bound_ms:.4f} ms ({k1_bytes} B at 3.35 TB/s)",
        flush=True,
    )

    # ---- 3. serve: one 800x800 view at full width --------------------------
    gen = torch.Generator().manual_seed(0)
    field = NGPRadianceField(aabb=AABB, device=dev, generator=gen, **FIELD_CFG)
    field.eval()

    def builder(ro, rd, fld=field):
        def rgb_sigma_fn(ts, te, ri):
            o, dd = gather_ray_od(ro, rd, ri)
            x = o + ((ts + te) / 2)[:, None] * dd
            rgb, sigma = fld(x, dd)
            return rgb, sigma[..., 0]

        return rgb_sigma_fn

    c2w = pose_spherical(math.radians(-30.0), math.radians(-30.0), 4.0)[:3, :4]
    K = np.array([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(WIDTH), np.arange(HEIGHT), indexing="xy")
    rays = generate_rays(xs, ys, K, c2w, device=dev)
    o_all = rays.origins.reshape(-1, 3)
    d_all = rays.viewdirs.reshape(-1, 3)
    bkgd = torch.ones(3, device=dev)

    def render(o, d):
        imgs, total = [], 0
        for j in range(0, o.shape[0], CHUNK):
            oc, dc = o[j : j + CHUNK], d[j : j + CHUNK]
            n_real = oc.shape[0]
            if n_real < CHUNK:  # pad the last chunk as examples/render.py does
                oc = torch.cat([oc, oc[-1:].expand(CHUNK - n_real, 3)])
                dc = torch.cat([dc, dc[-1:].expand(CHUNK - n_real, 3)])
            rgb, _, _, n_s = occgrid_render_rays_test(
                builder, est, state, oc, dc, render_bkgd=bkgd, **RENDER_KW
            )
            total += n_s
            imgs.append(rgb[:n_real])
        return torch.cat(imgs), total

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    occupancy_query.launches = 0
    t0 = time.perf_counter()
    img, total = render(o_all, d_all)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1_launches = occupancy_query.launches
    img = img.reshape(HEIGHT, WIDTH, 3)
    n_rays = WIDTH * HEIGHT
    print(
        f"serve: {n_rays} rays in {dt:.3f} s = {n_rays / dt:.1f} rays/s, "
        f"{total} samples, K1 launches {k1_launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B",
        flush=True,
    )
    if k1_launches <= 0:
        fail("the serve path never launched kernel K1")
    if not bool(torch.isfinite(img).all()) or img.shape != (HEIGHT, WIDTH, 3):
        fail("serve produced a non-finite or misshapen image")
    if not (0.0 <= float(img.min()) and float(img.max()) <= 1.0 + 1e-6):
        fail("serve produced colours outside [0, 1]")
    if total <= 0:
        fail("serve rendered no samples")

    # Every 8th chunk: the frame's mix of chunks, at a trace size that the
    # profiler processes in seconds (a whole frame takes minutes).
    sel = torch.cat([
        torch.arange(j, min(j + CHUNK, n_rays), device=dev)
        for j in range(0, n_rays, 8 * CHUNK)
    ])
    print(f"profile serve: {int(sel.numel())} rays (every 8th chunk)", flush=True)
    profile_window(
        lambda: render(o_all[sel], d_all[sel]),
        ("traverse_grids", "compact_indices_from_counts",
         "render_weight_from_density", "accumulate_along_rays"),
        "serve", "profile_serve.txt",
    )

    # ---- 4. card against CPU on a 64x64 crop --------------------------------
    r0 = (HEIGHT - CROP) // 2
    c0 = (WIDTH - CROP) // 2
    crop_o = rays.origins[r0 : r0 + CROP, c0 : c0 + CROP].reshape(-1, 3)
    crop_d = rays.viewdirs[r0 : r0 + CROP, c0 : c0 + CROP].reshape(-1, 3)
    rgb_gpu, opa_gpu, dep_gpu, n_gpu = occgrid_render_rays_test(
        builder, est, state, crop_o, crop_d, render_bkgd=bkgd, **RENDER_KW
    )
    cpu = torch.device("cpu")
    field_cpu = NGPRadianceField(aabb=AABB, device=cpu, **FIELD_CFG)
    field_cpu.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    state_cpu = est.set_binaries(est.init(cpu), state.binaries.cpu())
    t0 = time.perf_counter()
    rgb_cpu, opa_cpu, dep_cpu, n_cpu = occgrid_render_rays_test(
        lambda ro, rd: builder(ro, rd, fld=field_cpu), est, state_cpu,
        crop_o.cpu(), crop_d.cpu(), render_bkgd=bkgd.cpu(), **RENDER_KW,
    )
    print(f"CPU crop rendered in {time.perf_counter() - t0:.1f} s", flush=True)
    # atol 1e-4: the card sums in another order (atomic index_add_, GEMM
    # tiling), and those last-bit differences add up over ~1000 samples/ray.
    errs = {
        name: float((a.cpu() - b).abs().max())
        for name, a, b in (("rgb", rgb_gpu, rgb_cpu), ("opacity", opa_gpu, opa_cpu),
                           ("depth", dep_gpu, dep_cpu))
    }
    print(f"card vs CPU crop: max abs err {errs}, samples {n_gpu} vs {n_cpu}", flush=True)
    if n_gpu != n_cpu:
        fail(f"card and CPU rendered different sample counts ({n_gpu} vs {n_cpu})")
    if max(errs.values()) > 1e-4:
        fail(f"card and CPU disagree beyond atol 1e-4: {errs}")

    # ---- 5. K2, K4-w3, K3 against their plain versions ----------------------
    kt = kernels_vs_plain(dev)

    # ---- 6. train at full width ---------------------------------------------
    trained, train_launches, k1_train_err = train_full_width(dev)
    k1_max_err = max(k1_max_err, k1_train_err)

    # ---- 7. train step, card against CPU ------------------------------------
    w3_launches = train_card_vs_cpu(
        dev, {k: v.detach().clone() for k, v in trained.state_dict().items()}
    )

    # K1's launches here are the train path's (phase 6); the serve path's
    # are printed in phase 3.
    src = "nerfacc_tpu_torch/csrc/"
    kernels = [
        kernel_row("occupancy_query", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                   train_launches["K1"], k1_max_err, k1_ms, k1_plain_ms, k1_bytes, k1_ops, None),
    ] + [
        kernel_row(name, src + file, replaces, launches, kt[key]["err"], kt[key]["ms"],
                   kt[key]["plain_ms"], kt[key]["bytes"], kt[key]["ops"], kt[key].get("library_ms"))
        for name, key, file, replaces, launches in (
            ("table_grad_u10", "K2", "table_grad.cu", "nerfacc_tpu/ops/table_grad.py:749",
             train_launches["K2"]),
            ("table_grad_w3", "K4-w3", "table_grad.cu", "nerfacc_tpu/ops/table_grad.py:572",
             w3_launches),
            ("cell_max", "K3", "cell_max.cu", "nerfacc_tpu/ops/table_grad.py:1918",
             train_launches["K3"]),
        )
    ]
    print(card_line, flush=True)  # nvidia-smi's name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)


if __name__ == "__main__":
    main()
