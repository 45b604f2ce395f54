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


def profile_serve(render_chunks, n_rays: int) -> None:
    """Where the serve time goes: time ``render_chunks()`` without the
    profiler, then trace it with torch.profiler.  Prints the device's busy
    and idle share (kernel time over the untraced wall time), kernel time by
    stage of the render loop (the ``record_function`` ranges that
    ``rendering.py`` opens; kernels attributed by their place on the GPU
    timeline), and the top kernels.  The full table goes to
    chiprun_out/profile_serve.txt."""
    import bisect
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    stages = ("traverse_grids", "compact_indices_from_counts",
              "render_weight_from_density", "accumulate_along_rays")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_chunks()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_chunks()
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
        fail("profile: the profiler recorded no device activity")
    starts = [s_[0] for s_ in spans]
    per_stage = dict.fromkeys(stages + ("field and the rest",), 0.0)
    by_kernel = {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        inside = i >= 0 and e.time_range.start < spans[i][1]
        per_stage[spans[i][2] if inside else "field and the rest"] += us / 1e3
        t, c = by_kernel.get(e.name, (0.0, 0))
        by_kernel[e.name] = (t + us / 1e3, c + 1)
    host = dict.fromkeys(stages, 0.0)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in stages:
            host[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(per_stage.values()) / 1e3
    print(
        f"profile: {n_rays} rays (every 8th chunk) in {wall:.3f} s untraced "
        f"({n_rays / wall:.1f} rays/s), {wall_traced:.3f} s traced; device busy "
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
    (out / "profile_serve.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=60)
    )


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
    profile_serve(lambda: render(o_all[sel], d_all[sel]), int(sel.numel()))

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

    kernels = [
        {
            "name": "occupancy_query",
            "route": "cuda",
            "source": "nerfacc_tpu_torch/csrc/occ_query.cu",
            "replaces": "nerfacc_tpu/ops/occ_query.py:121",
            "launches": k1_launches,
            "max_abs_err": k1_max_err,
            "ms": k1_ms,
            "plain_ms": k1_plain_ms,
            "bound_ms": k1_bound_ms,
            "bound_by": "bytes" if k1_bound_bytes_ms >= k1_bound_ops_ms else "operations",
            "library_ms": None,
        }
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
