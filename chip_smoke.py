"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --phases 1,5   # a subset: build and kernel checks only

Phases (any failure exits non-zero; ``--phases`` runs a comma-separated
subset, phase 1 always, and prints the kernel table only when every phase
ran; phase 3 needs 2, phase 4 needs 3, phase 8 needs 6 and 7, phases 9 to
21 none):
1. card: name and power limit; build every kernel from ``nerfacc_tpu_torch/csrc``;
   what ``ptxas -v`` says of K1, K2, K3, K4 and K6 (registers, shared
   memory, spills).
2. kernel K1 (occupancy query) against its plain PyTorch version on the
   card, for exact equality, at the render shape and on adversarial points;
   timings with CUDA events.
3. serve: render one 800x800 view at the full-width configuration
   (``examples/render.py`` with the synthetic block of
   ``examples/train_ngp_nerf_occ.py``), random weights from seed 0, the
   occupancy shell of ``bench.py``; K1 must be launched on that path.
   Then every 8th chunk again, once plain and once under torch.profiler:
   where the device time goes and how long the device sits idle; and the
   view's central 64x64 rays (4096) with ``lattice_per_round=64`` on the
   card against the CPU.
4. card against CPU: a 64x64 crop of the same view through the port on the
   card and on the CPU, with the same weights.
5. the table-gradient kernels against their plain versions on the card, at
   the training shapes, with timings beside each kernel's bound: K2 (bf16),
   K4 (w3 in float32 and bf16, w8 in bf16 and float32) and K5 (bf16) at
   2^21 sample-levels over 4 x 2^15 rows; every one of K6's 15 instances
   (``K6_INSTANCES``: F = 1, 2, 4, 8, 16 at each split), each launched once
   by the grouped encoder's own bf16 backward at 2^14 samples and held on
   that call's inputs, then held and timed at 2^19 samples over the
   encoder's F spans of 2^16 rows; and K3 (per-cell max) at 2^20 draws;
   each kernel's share of its bound, the zeroing of the output, the sorts
   and the ``quantize_u10`` of K2's weights (ahead of K2 on the main path);
   K5 once a level, as ``hash_table_lookup_sized`` and the fused encoder's
   pallas route launch it: level 1 of the 4 (2^19 sample-levels over its
   2^15 rows) held and timed, one lookup's backward over that level (the
   other levels' rows zero) and one over all 4 (4 launches); and one
   ``hash_lookup_combine`` backward (bf16, 2^21 sample-levels): K4-w8
   launched once and held against its plain version.
6. train: the NGP-occ train step of ``bench.py:59-294`` at its full width
   (16384 rays, 2^19 samples, bf16 compute, the fused encoder L4 x F16),
   3 warm-up steps, 30 timed steps and 8 timed occupancy updates;
   samples/s, step and update ms, the launches of K1, K2 and K3 on that
   path, peak memory, first and last loss; K1 against its plain version on
   one step's skip probes and lattice queries, and K3 on one update's
   draws, each timed beside its bound; then a few steps under
   torch.profiler.
7. train, tcnn shape: the same step with ``BENCH_ENCODER=grouped
   BENCH_LEVELS=16 BENCH_FEATS=2 BENCH_LOG2T=19`` (the grouped encoder, a
   (2 x 2^16, 128) table, 8 fetches a sample), the same counts and prints,
   with the launches of K1, K6 and K3.
8. card against CPU: the traversal of 1024 rays at 2^15 and 2^17 slots
   (every field), then one train step at 1024 rays and 2^15 samples, full
   field width, same weights, jitter and draws, for each table-gradient
   route: the fused encoder at float32 (K4-w3, with one occupancy update)
   and bf16 (K2), the grouped encoder at bf16 (K6) and float32 (autograd),
   and at splits 2 and 8 (K6 at 8 and 2 columns a corner), and the fused
   encoder with ``table_grad="pallas"`` (K5 once a level, bf16),
   ``factor_pack="w8"`` (K4-w8, bf16 and float32) and ``"w3"`` (K4-w3,
   bf16): the kept samples, the loss, every gradient and the parameters
   after Adam must agree, and each route must launch its kernel.
9. train, float32: phase 6's step at ``compute_dtype=None``, as
   ``bench.py`` runs it with ``BENCH_DTYPE=f32`` and as the JAX package's
   training example runs by default (``--dtype f32``): the fused encoder's
   table gradient then launches K4-w3 in float32 every step.  The same
   counts and prints as phase 6, with the launches of K1, K4-w3 and K3, and
   a profile window; needs no other phase.
10. train and eval, unbounded: the Mip-NeRF 360 configuration of
   ``examples/train_ngp_nerf_occ.py:62-71`` (4 grid levels of 128^3, near
   0.2, step 1e-3, cone 0.004, the visibility filter at ``alpha_thre``
   1e-2, the contracted field at the example's default width L8 x F16,
   float32, 8192 rays, 2^18 samples), its occupancy state from the
   estimator's own updates (a warm-up update of every cell, then rounds of
   16 steps and an update); 3 warm-up steps, 30 timed steps and 8 timed
   updates with phase 6's prints, the filter's threshold and drop share,
   ``macro_truncated_frac``, and the launches of K1, K4-w3 and K3 (exactly
   one K4-w3 a step and four K3 an update); K1 and K3 on the phase's own
   inputs, timed; a profile window with a ``visibility`` stage; one 800x800
   eval view through the filter (``eval_render``, ``:309-322``); one step at
   1024 rays and a 64x64 eval crop on the card against the CPU, where
   visibility masks may differ only at threshold-adjacent samples.  Needs
   no other phase.
11. train and eval, proposal network: the Mip-NeRF 360 block of
   ``examples/train_ngp_nerf_prop.py:67-74,107-131`` (two ``NGPDensityField``
   proposal nets at max resolution 128 and 256, 5 levels, F = 2, proposal
   samples (256, 96), 48 final samples, lindisp from 0.2 to 1e3, an opaque
   background; the contracted radiance field L8 x F16, float32; 4096 rays);
   3 warm-up steps (one with a proposal update, one without, then the
   cadence's step 1000) and 30 timed steps at the proposal cadence from
   step 1001 (one update in six): rays/s, radiance samples/s, step ms, each variant
   (``requires_grad`` True and False) timed alone, peak memory, first and
   last loss and proposal loss, exactly one K4-w3 launch a step and no other
   kernel; K4-w3 on one step's own inputs, timed beside its bound; a profile
   window (``prop_sampling``, ``field_forward``, ``gather_combine``,
   ``rendering``, ``prop_loss``, ``table_grad``); one 800x800 eval view
   (``requires_grad=False``, 8192-ray chunks); one step at 1024 rays on the
   card against the CPU, in stages (sampling given the card's densities, the
   step on the card's samples, the chained step).  Needs no other phase.
12. the first trained scene: ``bench.py``'s quality run (``QUALITY_*``)
   through the occupancy CLI's own ``train_step`` and ``train``: the
   textured procedural scene generated on the card at 800x800 (timed; a
   32x32 crop of a training view within one uint8 step of the CPU), up to
   1000 steps or 120 s of train time with an eval PSNR of the test view
   every 250 steps (outside the clock); train seconds and steps to 33 dB
   (or null), the final PSNR, SSIM, MS-SSIM and LPIPS (``rnd`` without a
   weights file), kept samples/s, a late step's ms, samples per ray and the
   occupied share at each eval, peak memory; K1 as often a step as the
   traversal queries it and K2 once a step, each held against its plain
   version on a late step's own inputs; the final PSNR at least 30 dB; the
   test view served through the render CLI (rays/s on the trained grid), and
   a checkpoint saved, restored and rendered again, within 1e-6; then a
   late step's ms with the loader's batches from the native sampler and
   from the numpy path, in turns (32 steps each).  Needs no
   other phase (it prints phase 6's step and phase 3's rays/s beside its
   own when those ran).
13. the vanilla NeRF, trained: ``train_mlp_nerf``'s own ``train``,
   ``train_step``, ``occ_update`` and ``eval_render`` at the CLI's
   NeRF-Synthetic block (``MLP_*``: aabb +-1.5, res-128 grid, step 5e-3,
   1024 rays x 64 slots, the 8 x 256 field) on phase 12's textured scene at
   800x800, up to 3000 steps or 45 s of train time, an eval of the test view
   every 500 steps; step and update ms, kept samples/s, rays/s, samples a
   ray, the occupied share, peak memory, first and last loss, one 800x800
   eval view's rays/s, PSNR and SSIM; K1 as often a step as the traversal
   queries it and K3 once an update, each held against its plain version on
   the phase's own inputs; a profile of three late steps with the share of
   the scan's gather backward; one step at 256 rays on the card against the
   CPU; the final PSNR at least ``MLP_GATE_DB`` and the last 16 steps' mean
   loss below the first 16 steps'.  Needs no other phase.
14. T-NeRF and NDR: ``train_mlp_tnerf``'s T-NeRF (``TNERF_*``: res-128
   grid, 1024 rays x 48 slots) for 200 steps on the dynamic procedural
   scene, step ms and rays/s, K1 and K3 counted and held against their
   plain versions on the phase's own inputs, a profile of three late steps;
   one T-NeRF step and one NDR step at 256 rays on the card against the
   CPU.  Needs no other phase.
15. the other encoders and the structure-of-arrays route: (a) ``bench.py``'s
   step with ``BENCH_ENCODER=hash BENCH_LEVELS=16 BENCH_FEATS=2
   BENCH_LOG2T=19`` (tcnn's parametrisation, the table gradient autograd's
   ``index_add_``) as phase 6 times it, with K1 and K3 on its own inputs, a
   profile and the share of ``index_add_`` and ``index_select``; (b) phase
   6's step on the SoA route (``carry_rays``, ``rgb_sigma_soa_fn``,
   ``soa_positions=True``) held against the array route on the card (the
   same compaction, loss and table gradient within 1e-6 of its largest
   entry, the update bit-equal), both timed, K2 once a step and K3 once an
   update as on the array route, each on the route's own inputs; (c) one
   step on the card against the CPU for the folded encoder, soa and the
   fused scatter route, each from four weight seeds (float32: loss rtol
   1e-5, gradients 3e-4, or 3e-3 at the table entries and ray origins that
   a sample feeds whose ReLU input changed sign, the ray origins' gradient
   too), for chunk-paired levels on the factor (K2) and
   pallas (K5 once a level) routes and for the grouped encoder's factor
   (K6) and scatter (no kernel; the ray origins' gradient too) routes
   (bf16: gradients 2e-2, loss 1e-5), then 30 timed
   folded steps; (d) ``traverse_grids``' macro-skip branch on phase 3's grid
   against its dense branch, K1's skip probes exact and counted.  Needs no
   other phase.
16. the plug-in fields TensoRF and K-Planes (``PLUGIN_*``): each trained
   through ``train_ngp_nerf_occ``'s own ``train`` (``--field tensorf|kplanes``,
   its synthetic block: aabb +-1.5, res-128 grid, step 5e-3, 8192 rays,
   2^18 slots) at the CLI's widths on its procedural scene (160x160) for
   up to 45 s of train time: step and update ms, kept samples/s, the eval
   views' PSNR, peak memory, first and last loss; K1 as often a step as the
   traversal queries it and K3 once an update, each held against its plain
   version on the phase's own inputs; a profile of three late steps with
   the plane and line gathers' backward (``index_add_``) shares; one step at
   256 rays on the card against the CPU (loss rtol 1e-5, gradients 3e-4 of
   their largest entry); the last 16 steps' mean loss below the first 16's;
   a late step's ms with native and numpy batches in turns, as phase 12.
17. TiNeuVox: phase 14's run with ``train_mlp_tnerf --field tineuvox``
   (resolution 96): step ms, rays/s, K1 and K3 counted and held against
   their plain versions, a profile with the voxel taps' backward share, one
   step at 256 rays on the card against the CPU.
18. BARF: ``train_barf`` at its non-smoke widths (8 x 256 field, 24 views of
   160x160, 64^3 grid, 1024 rays x 64 slots, pose noise 0.10) with its
   schedules over ``BARF_MAX_STEPS``: the initial and refined rotation and
   translation errors (the refined rotation error must be below the
   initial), the eval views' PSNR, step ms, K1's launches held against its
   plain version (no K3 at 64^3), a profile with the shares of
   ``gather_ray_od``'s backward and the scan's, and one step at 256 rays on
   the card against the CPU, the pose gradient included (loss rtol 1e-5,
   gradients 3e-4 of their largest entry).
19. a Mip-NeRF 360 capture, loaded and trained: the host libraries
   (``csrc/*.cpp``) built by ``g++``; the committed JPEG fixtures
   (``tests/fixtures/jpeg``) decoded bit-equal to their arrays; the native
   sampler taken by a procedural loader's training batch, its rays held
   against the numpy path's geometry, a fetch timed through each path; a
   COLMAP capture of the textured procedural scene (``CAPTURE_*``: 192 views
   on three rings inside a textured backdrop sphere, PINHOLE, PNG) rendered
   on the card and written under
   ``build/``, loaded by the occupancy CLI's ``setup`` (``--scene garden
   --data_root``: the 360 loader at factor 4) and trained through its
   ``train`` at the unbounded block's full width (the dynamic ray count)
   for up to 3000 steps or 50 s: train seconds, a late step's ms, the ray
   count, kept samples/s, the visibility
   filter's drop share, the fetch stage's host ms, peak memory, a profile of
   three late steps (idle share, top kernels, the scan's gather backward),
   the eval PSNR of the every-8th test views (at least ``CAPTURE_GATE_DB``),
   the loss falling; K1 2 a step, K4-w3 1 a step and K3 4 an update, each
   held against its plain version on the phase's own inputs.
20. the profiler tools: ``python -m nerfacc_tpu_torch.scripts.run_profiler``
   at the bench configuration (a time for every stage) and ``...
   capture_trace`` over 3 steps and one update (its table names K1, K2 and
   K3).
21. ``nerfacc_tpu_torch.parallel``: (a) a world of one over NCCL at phase
   6's configuration: one parallel step against phase 6's ``train_step``
   and one parallel update against ``_update`` on the same weights,
   jitter, batch and draws, then 3 warm-up and 30 timed steps and 8 timed
   updates (step and update ms beside phase 6's, samples/s, peak memory, the
   gradient buffer's bytes), a profile with the ``all_reduce``'s ms, K1, K2
   and K3 on the path's own inputs, and the 800x800 view through
   ``make_parallel_test_renderer`` against ``occgrid_render_rays_test``,
   with K1, K2 and K3 counted over the steps, updates and view; (b) two
   processes on the one card over gloo (this script run with
   ``--parallel-worker RANK PORT DIR``), each holding half of 1024 rays at
   full field width in float32: the 2-rank step, update and render against
   one process on the union of the rays and of the draws (a correctness
   run, not a scaling one), with K1, K3 and K4-w3 counted in each rank's
   step, update and render and held on rank 0's own inputs.
The last two lines are the kernel table and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import argparse
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
# bench.py's tcnn-shape arm (BENCH_ENCODER=grouped BENCH_LEVELS=16
# BENCH_FEATS=2 BENCH_LOG2T=19; examples/radiance_fields/ngp.py:99-137).
GROUPED_FIELD_CFG = dict(
    encoder_type="grouped", n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
    mlp_width=64, geo_feat_dim=15,
)
TRAIN_RAYS, TRAIN_CAPACITY, TRAIN_MACRO = 16384, 1 << 19, 4
TRAIN_ITERS, TRAIN_UPDATES = 30, 8
# Phase 10: the Mip-NeRF 360 configuration of examples/train_ngp_nerf_occ.py
# (:62-71: aabb +-1, 4 grid levels, near 0.2, step 1e-3, cone 0.004, alpha
# threshold 1e-2, the unbounded field; the fused encoder at its defaults,
# :164-170, that is FIELD_CFG; float32; 8192 rays and 2^18 samples, :49,238;
# the eval render of :309-322 in 8192-ray chunks of 64 samples a ray).
UNB_ROI = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
UNB_LEVELS = 4
UNB_RENDER_KW = dict(
    near_plane=0.2, render_step_size=1e-3, cone_angle=0.004, alpha_thre=1e-2, max_macro_segments=24,
)
UNB_RAYS, UNB_CAPACITY, UNB_CHUNK = 8192, 1 << 18, 8192
# The state is built as the example's loop builds it: one warm-up update of
# every cell, then rounds of 16 steps and a post-warm-up update.
UNB_STATE_ROUNDS = 2
# Phase 11: the unbounded block of examples/train_ngp_nerf_prop.py (:67-74,
# 107-131): aabb +-1, lindisp from 0.2 to 1e3, proposal samples (256, 96)
# and 48 final samples, an opaque background; two proposal nets (5 levels,
# F = 2, log2_hashmap_size 17, max_resolution 128 and 256) and the radiance
# field at its fused default (FIELD_CFG), all contracted, float32; 4096 rays
# a step (:98), the eval in 8192-ray chunks (:206-223).  The timed steps
# start at step 1000 of the proposal cadence: one update in six.
PROP_AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
PROP_RENDER_KW = dict(
    num_samples=48, prop_samples=(256, 96), near_plane=0.2, far_plane=1e3, sampling_type="lindisp",
    opaque_bkgd=True,
)
PROP_NET_CFG = dict(n_levels=5, n_features_per_level=2, log2_hashmap_size=17, mlp_width=64)
PROP_MAX_RES = (128, 256)
PROP_RAYS, PROP_CHUNK, PROP_START_STEP, PROP_VARIANT_ITERS = 4096, 8192, 1000, 10
# Phase 12: bench.py's quality run (:296-350, :497-560, :644-680), through
# the occupancy CLI's own train_step and loop: the textured procedural scene
# at 800x800 (36 train views, 1 test view), aabb +-1, a 64^3 single-level
# grid, step 5e-3, 8192 rays and 8192 x 32 sample slots, macro budget 24;
# the fused encoder L4 x F16 with 2^18 entries, bf16, table_grad="factor"
# (K2); constant Adam (1e-2, eps 1e-15), Huber loss.  Bounded to 1000 steps
# (3000 before phase 19 took its share of the run, 2000 before the whole run
# passed 800 s; 33 dB comes by step 250) or 120 s of train time; an eval
# every 250 steps (outside the clock).
QUALITY_SIZE, QUALITY_TRAIN_VIEWS, QUALITY_RAYS = 800, 36, 8192
QUALITY_GRID_RES, QUALITY_STEP, QUALITY_MACRO = 64, 5e-3, 24
QUALITY_FIELD = dict(levels=4, feats=16, log2t=18, dtype="bf16")
QUALITY_MAX_STEPS, QUALITY_BUDGET_S, QUALITY_EVAL_EVERY = 1000, 120.0, 250
QUALITY_TARGET_DB, QUALITY_GATE_DB = 33.0, 30.0
QUALITY_EVAL_CHUNK, QUALITY_CROP = 8192, 32
# Phase 13: the vanilla NeRF of examples/train_mlp_nerf.py at its
# NeRF-Synthetic block (:76-90): aabb +-1.5, a res-128 single-level grid,
# step 5e-3, near 0, 1024 rays x 64 slots, VanillaNeRFRadianceField at its
# full width (8 x 256, skip 4, condition 1 x 128), Adam 5e-4, Huber loss,
# an update every 16 steps (every cell below step 256), the eval in
# 8192-ray chunks.  The textured procedural scene at 800x800 (phase 12's
# generator, 36 train views) stands in for Lego.  Bounded to 3000 steps or
# 45 s of train time (60 s before phase 19 took its share of the run).
MLP_RAYS, MLP_TRAIN_VIEWS, MLP_MAX_STEPS, MLP_BUDGET_S = 1024, 36, 3000, 45.0
MLP_EVAL_EVERY, MLP_EVAL_CHUNK, MLP_CPU_RAYS = 500, 8192, 256
MLP_GATE_DB = 20.0
# Phase 14: examples/train_mlp_tnerf.py's T-NeRF at its D-NeRF block
# (:71-82: aabb +-1.5, res-128 grid, step 5e-3, 1024 rays x 48 slots) on the
# dynamic procedural scene (24 train views of 400x400, D-NeRF's usual
# half-resolution size), 200 steps.
TNERF_SIZE, TNERF_TRAIN_VIEWS, TNERF_STEPS = 400, 24, 200
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
    outside it, in z cells that are the last bit of a word, with +-inf and
    NaN coordinates (every point of ``{0, 0.3, -0.2, 1.2, +inf, -inf,
    NaN}^3`` too), and at random."""
    lo, ext = aabb[:3], aabb[3:] - aabb[:3]
    faces = []
    for lvl in range(levels):
        k = np.arange(res + 1, dtype=np.float32) / res - 0.5  # level-0 faces
        faces.append(k * 2.0**lvl)
    faces = np.concatenate(faces)
    special = np.array([-0.5, 0.5, -0.5000001, 0.4999999, 0.0, np.inf, -np.inf, np.nan], np.float32)
    z31 = ((np.arange(31, res, 32) + 0.5) / res - 0.5).astype(np.float32)
    coords = np.concatenate([faces, special, z31])
    n_side = coords.shape[0]
    grid = np.stack(np.meshgrid(coords[: min(n_side, 96)], coords, z31, indexing="ij"), -1)
    v = np.array([0.0, 0.3, -0.2, 1.2, np.inf, -np.inf, np.nan], np.float32)
    pts = [grid.reshape(-1, 3), np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)]
    pick = rng.integers(0, n_side, size=(200_000, 3))
    pts.append(coords[pick])
    scale = 2.0 ** (levels + 1)
    pts.append(rng.uniform(-scale, scale, size=(200_000, 3)).astype(np.float32))
    nrm = np.concatenate(pts).astype(np.float32)
    return (lo + (nrm + 0.5) * ext).astype(np.float32)


def profile_window(run, stages, what: str, out_name: str) -> dict:
    """Where the time of ``run()`` goes: time it without the profiler, then
    trace it with torch.profiler.  Prints the device's busy and idle share
    (kernel time over the untraced wall time), kernel time by stage (the
    ``record_function`` ranges named in ``stages``; each kernel goes to the
    innermost range whose span on the GPU timeline holds it, the rest to
    "unattributed"), and the top kernels.  The full table goes to
    ``chiprun_out/<out_name>``.  Returns the device's busy milliseconds and
    the untraced wall milliseconds, each kernel's ``(ms, count)`` by name,
    and each stage's device milliseconds and traced host milliseconds."""
    import bisect
    import gc
    import itertools
    from pathlib import Path

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # The CUDA graphs of earlier timings free their memory pools when
    # collected; collect them now, not inside the untraced run.
    gc.collect()
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
    return dict(busy_ms=busy * 1e3, wall_ms=wall * 1e3, kernels=by_kernel, stages=per_stage, host=host)


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


def train_step(field, opt, est, state, rays_o, rays_d, pixels, jitter, capacity, render_kw=None,
               sigma_fn=None, soa=False, paired_levels=0):
    """One step of bench.py's train loop: render, Huber loss, backward, Adam.
    ``render_kw`` replaces bench.py's traversal settings; ``sigma_fn`` (a
    wrapper of the field's density, see :func:`density_fn`) turns on the
    visibility filter where ``render_kw`` sets ``alpha_thre``.  ``soa`` takes
    the structure-of-arrays route (``BENCH_SOA``: the traversal adds each
    slot's ray components and the field gets ``(xs, ys, zs)`` tuples);
    ``paired_levels`` goes to the field.  Returns the loss and the
    kept-sample count, both on the device, and the renderer's extras."""
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays
    from torch.profiler import record_function

    def rgb_sigma_fn(ts, te, ri):
        o, d = gather_ray_od(rays_o, rays_d, ri)
        rgb, sigma = field(o + ((ts + te) / 2)[:, None] * d, d, paired_levels=paired_levels)
        return rgb, sigma[..., 0]

    def rgb_sigma_soa_fn(o, d, ts, te):
        mid = (ts + te) / 2
        rgb, sigma = field(tuple(o[k] + mid * d[k] for k in range(3)), d, paired_levels=paired_levels)
        return rgb, sigma[..., 0]

    if render_kw is None:
        render_kw = dict(near_plane=0.0, render_step_size=STEP, max_macro_segments=TRAIN_MACRO)
    colors, _, _, n_samp, extras = occgrid_render_rays(
        rgb_sigma_fn, sigma_fn, est, state, rays_o, rays_d, far_plane=1e10,
        render_bkgd=torch.ones(3, device=rays_o.device), stratified=True, jitter=jitter,
        sample_capacity=capacity, rgb_sigma_soa_fn=rgb_sigma_soa_fn if soa else None, **render_kw,
    )
    loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
    opt.zero_grad(set_to_none=True)
    with record_function("backward"):
        loss.backward()
    with record_function("optimizer"):
        opt.step()
    return loss.detach(), n_samp, extras


def density_fn(field, rays_o, rays_d, record=None):
    """The examples' ``sigma_fn``: the field's density at the sample
    midpoints.  With a list ``record``, each call appends its inputs and its
    output, ``(t_starts, t_ends, ray_indices, sigmas)``."""
    from nerfacc_tpu_torch.rendering import gather_ray_od

    def sigma_fn(ts, te, ri):
        o, d = gather_ray_od(rays_o, rays_d, ri)
        sigma = field.query_density(o + ((ts + te) / 2)[:, None] * d)[..., 0]
        if record is not None:
            record.append((ts, te, ri, sigma))
        return sigma

    return sigma_fn


def occ_update(est, state, field, **draw_kw):
    """bench.py's occupancy update (post-warmup draws, 2^20 at res 128);
    ``soa_positions=True`` among ``draw_kw`` hands the field ``(xs, ys,
    zs)`` tuples (``BENCH_OCC_SOA``)."""
    from torch.profiler import record_function

    with record_function("occ_update"):
        return est._update(
            state, 10**9, lambda x: field.query_density(x) * STEP, **draw_kw
        )


def k1_on_train_inputs(step, state) -> dict:
    """K1 against its plain version on the queries that one train step gives
    it: the macro-skip probes on ``state.skip_packed`` (``mip_pad=1``) and
    the lattice queries on ``state.binaries_packed``, recorded as
    ``traverse_and_compact`` makes them.  Exact, and equal to ``_query_soa``
    on the unpacked grid; each timed beside its bound.  Returns the largest
    difference (``err``) and, under ``lattice``, the lattice queries' times,
    bytes and operations."""
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
    kinds, timed, err, lattice = set(), set(), 0.0, None
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
        if (label, mip_pad) in kinds - timed:
            timed.add((label, mip_pad))
            ms = time_ms(lambda: occupancy_query(packed, aabb, *pts, rz=rz, mip_pad=mip_pad))
            plain_ms = time_ms(lambda: occupancy_query_plain(packed, aabb, *pts, rz=rz, mip_pad=mip_pad))
            nbytes, ops = k1_bytes_ops(pts[0].numel(), packed)
            bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
            print(f"K1 train path, {label} mip_pad={mip_pad}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({nbytes} B), {100 * bound / ms:.1f}% of bound", flush=True)
            if label == "binaries_packed":
                lattice = dict(ms=ms, plain_ms=plain_ms, bytes=nbytes, ops=ops)
    if kinds != {("skip_packed", 1), ("binaries_packed", 0)}:
        fail(f"K1 on the train path: expected skip probes and lattice queries, saw {sorted(kinds)}")
    return dict(err=err, lattice=lattice)


def k3_checked_and_timed(label, ids, vals, n_cells, dev) -> dict:
    """K3 on ``(ids, vals)``: exact against its plain version and
    ``scatter_reduce_(amax)``, then its time, the plain version's, the
    library call's and the bytes of its bound."""
    from nerfacc_tpu_torch.ops.table_grad import cell_max, cell_max_plain

    ids_long = ids.long()

    def library():
        return torch.full((n_cells,), -1.0, device=dev).scatter_reduce_(0, ids_long, vals, "amax")

    got, plain, lib = cell_max(ids, vals, n_cells), cell_max_plain(ids, vals, n_cells), library()
    torch.cuda.synchronize()
    err = float((got - plain).abs().max())
    print(f"K3 {label}: {ids.numel()} draws into {n_cells} cells, {int((got >= 0).sum())} cells touched, "
          f"max abs err {err} against plain, equal to scatter_reduce(amax): {torch.equal(got, lib)}", flush=True)
    if not (torch.equal(got, plain) and torch.equal(got, lib)):
        fail(f"K3 ({label}) is not exact against its plain version and scatter_reduce(amax)")
    o = dict(
        err=err, ms=time_ms(lambda: cell_max(ids, vals, n_cells)),
        plain_ms=time_ms(lambda: cell_max_plain(ids, vals, n_cells)), library_ms=time_ms(library),
        bytes=ids.numel() * 8 + n_cells * 4, ops=ids.numel(),
    )
    bound = o["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"K3 {label}: kernel {o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, scatter_reduce "
          f"{o['library_ms']:.4f} ms, bound {bound:.4f} ms, {100 * bound / o['ms']:.1f}% of bound", flush=True)
    return o


def k3_on_update_inputs(update, dev, levels=1) -> dict:
    """K3 on the ids and values that one real occupancy update gives it
    (bench.py's post-warmup draws: a uniform half and a ``sysrow`` half of
    rows of 128 ascending occupied ids), recorded as ``_update`` passes
    them: one call a level, each exact, the first timed."""
    import nerfacc_tpu_torch.estimators.occ_grid as occ_mod
    from nerfacc_tpu_torch.ops.table_grad import cell_max_plain

    cell_max = occ_mod.cell_max
    calls = []

    def recording(ids, vals, n_cells):
        calls.append((ids, vals, n_cells))
        return cell_max(ids, vals, n_cells)

    occ_mod.cell_max = recording
    try:
        update()
    finally:
        occ_mod.cell_max = cell_max
    if len(calls) != levels:
        fail(f"K3 on the update: expected one call a level ({levels}), saw {len(calls)}")
    for lvl, (ids, vals, n_cells) in enumerate(calls[1:], start=1):
        if not torch.equal(cell_max(ids, vals, n_cells), cell_max_plain(ids, vals, n_cells)):
            fail(f"K3 is not exact against its plain version on level {lvl} of one update")
    return k3_checked_and_timed("on one update's draws", *calls[0], dev)


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
            res.append({k: v.cpu() for k, v in cs._asdict().items() if v is not None})
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


def shell_points(rng, n: int, dev) -> torch.Tensor:
    """``(n, 3)`` sample points as the train path meets them: around
    bench.py's occupancy shell, in the field's [0, 1] box."""
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    radius = 0.225 * (1.0 + rng.uniform(-0.18, 0.18, size=(n, 1)))
    return torch.from_numpy((0.5 + radius * dirs).astype(np.float32)).to(dev)


# Every K6 instance held in phase 5, as (F, keys_per_row): each
# keys_per_row that divides J = 16 / F, so windows of 16 / keys_per_row
# columns a corner (the 15 (jg, F) instances of csrc/table_grad_pos.cu), at
# the grouped encoder's own shape: 16 levels, log2_hashmap_size 16 (what
# NGPRadianceField gives it from its 19), so 16 / J spans of 2^16 rows.
K6_INSTANCES = tuple((F, k) for F in (1, 2, 4, 8, 16) for k in (1, 2, 4, 8, 16) if (16 // F) % k == 0)
K6_LOG2T = 16
K6_SMALL = 1 << 14  # samples of the encoder's own backward that launches each instance


def k6_label(F: int, keys_per_row: int) -> str:
    return "K6" if (F, keys_per_row) == (2, 4) else f"K6-F{F}-split{keys_per_row}"


def k6_row_name(F: int, keys_per_row: int) -> str:
    """The kernel table's name of a K6 instance (F = 2 keeps its earlier names)."""
    if (F, keys_per_row) == (2, 4):
        return "table_grad_pos"
    return f"table_grad_pos_split{keys_per_row}" if F == 2 else f"table_grad_pos_F{F}_split{keys_per_row}"


def k6_inputs(u, rng, dev, F=2, keys_per_row=4, log2t=16) -> tuple:
    """K6's arguments at the grouped train shape: the points ``u`` through
    the grouped encoder of 16 levels x ``F`` features (by default the tcnn
    shape: 2 spans of 2^16 rows, 8 fetches a sample), the sorted (row,
    fetch) keys and their permutation, bf16 cotangents from ``rng``, with
    the fetch constants; then the unsorted keys and the mask of rows that no
    fetch names."""
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped
    from nerfacc_tpu_torch.ops.table_grad import FetchConsts

    genc = HashGridEncoderGrouped(n_features_per_level=F, log2_hashmap_size=log2t, keys_per_row=keys_per_row,
                                  device=dev)
    gx, gy, gz = (u[:, i].contiguous() for i in range(3))
    g_rows = genc.fetch_rows(gx, gy, gz)
    (nf, n), g_n_rows = g_rows.shape, genc.table.shape[0]
    cols = len(genc.fetches[0].res) * F
    g_key = (g_rows * nf + torch.arange(nf, device=dev)[:, None]).reshape(-1).to(torch.int32)
    g_sorted, g_perm = torch.sort(g_key)
    g_dout = torch.from_numpy((rng.standard_normal((nf * n, cols)) * 1e-3).astype(np.float32)).to(dev).to(torch.bfloat16)
    g_untouched = torch.bincount(g_rows.reshape(-1), minlength=g_n_rows) == 0
    args = (g_sorted, g_perm, gx, gy, gz, g_dout, g_n_rows, genc.fetches, F,
            FetchConsts(genc._fetch_res, genc._fetch_is_key, genc._fetch_win))
    return args, g_key, g_untouched


def k6_through_the_encoder(dev, F, keys_per_row, rng) -> tuple:
    """One bf16 forward and backward of the grouped encoder (``F``,
    ``keys_per_row``, ``K6_LOG2T``) on ``K6_SMALL`` points around the shell:
    the backward must launch K6 once (its count zeroed just before, read just
    after), and the kernel is then held against its plain version on the
    arguments of that call.  Returns the launches and the error."""
    import nerfacc_tpu_torch.ops.table_grad as tg
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped

    enc = HashGridEncoderGrouped(n_features_per_level=F, log2_hashmap_size=K6_LOG2T, keys_per_row=keys_per_row,
                                 compute_dtype=torch.bfloat16, device=dev)
    out = enc(shell_points(rng, K6_SMALL, dev))
    dout = torch.from_numpy((rng.standard_normal(tuple(out.shape)) * 1e-3).astype(np.float32)).to(dev, out.dtype)
    kernel, calls = tg.table_grad_pos, []

    def recording(*args):
        calls.append(args)
        return kernel(*args)

    # The encoder's backward and the wrapper's own count both look K6 up in
    # its module, so while the recorder stands there the launches count on it.
    recording.launches = 0
    tg.table_grad_pos = recording
    try:
        out.backward(dout)
        torch.cuda.synchronize()
        launches = recording.launches
    finally:
        tg.table_grad_pos = kernel
    if launches != 1 or len(calls) != 1:
        fail(f"{k6_label(F, keys_per_row)}: the grouped encoder's backward launched K6 {launches} times, not once")
    got, want = kernel(*calls[0]), tg.table_grad_pos_plain(*calls[0])
    torch.cuda.synchronize()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if not err <= 1e-5 * scale:
        fail(f"{k6_label(F, keys_per_row)} disagrees with its plain version on the encoder's backward: "
             f"{err} > 1e-5 * {scale}")
    return launches, err


def fused_inputs(u, rng, dev) -> tuple:
    """The fused encoder's table-gradient inputs at the train shape: the
    points ``u`` through the bench encoder's rows (4 levels of 2^15 rows; the
    coarsest, 16^3 cells, is indexed densely, so a quarter of the samples
    pile onto 4096 rows), sorted with their permutation, the float32
    fractions, float32 cotangents from ``rng`` and the row count."""
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderFused

    enc = HashGridEncoderFused(
        n_levels=4, n_features_per_level=16, log2_hashmap_size=15, device=dev
    )
    rows, ws = enc.cell_indices(u)
    idx = rows.reshape(-1).to(torch.int32)
    sorted_idx, perm = torch.sort(idx)
    wx, wy, wz = (w.reshape(-1).contiguous() for w in ws)
    dout = torch.from_numpy(
        (rng.standard_normal((idx.numel(), 16)) * 1e-3).astype(np.float32)
    ).to(dev)
    return idx, sorted_idx, perm, (wx, wy, wz), dout, enc.table.shape[0]


def kernels_vs_plain(dev) -> dict:
    """Phase 5: K2, K4 (its four modes), K5, K6 and K3 against their plain
    versions at the training shapes, and their times."""
    from nerfacc_tpu_torch.ops.table_grad import (
        corner_weights,
        hash_lookup_combine,
        hash_table_lookup_sized,
        quantize_u10,
        table_grad_pos,
        table_grad_pos_plain,
        table_grad_sorted,
        table_grad_sorted_plain,
        table_grad_u10,
        table_grad_u10_plain,
        table_grad_w3,
        table_grad_w3_plain,
        table_grad_w8,
        table_grad_w8_plain,
    )

    rng = np.random.default_rng(1)
    # Sample points around the occupancy shell through the bench encoder.
    n = TRAIN_CAPACITY
    u = shell_points(rng, n, dev)
    idx, sorted_idx, perm, (wx, wy, wz), dout, n_rows = fused_inputs(u, rng, dev)
    n_sl = idx.numel()
    wq = quantize_u10(wx, wy, wz)
    bf = torch.bfloat16
    dout_bf = dout.to(bf)
    w3_bf = [w.to(bf) for w in (wx, wy, wz)]
    w8 = corner_weights(wx, wy, wz).contiguous()
    w8_bf = w8.to(bf)
    # K5's input: the cotangent of the gathered rows as autograd of the bf16
    # combine gives it, bf16(w_c * dout_f).
    dg = (w8_bf.float()[:, :, None] * dout_bf.float()[:, None, :]).to(bf).reshape(n_sl, 128)
    rows_hit = int((torch.bincount(idx[: n_sl // 4].long(), minlength=4096) > 0).sum())
    untouched = torch.bincount(idx.long(), minlength=n_rows) == 0
    print(f"K2/K4/K5 inputs: {n_sl} sample-levels over {n_rows} rows, level 0 on {rows_hit} rows", flush=True)

    out = {}

    def held_and_timed(label, kern, plain, args, zero_rows) -> dict:
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        # atol 1e-5 of the largest row sum: the same terms summed in
        # float32 in another order.
        print(f"{label}: max abs err {err:.3e} against plain (largest row sum {scale:.3e})", flush=True)
        if not err <= 1e-5 * scale:
            fail(f"{label} disagrees with its plain version: {err} > 1e-5 * {scale}")
        if bool(got[zero_rows].any()):
            fail(f"{label} wrote rows that no sample names")
        del got, want
        return dict(err=err, ms=time_ms(lambda: kern(*args)), plain_ms=time_ms(lambda: plain(*args), calls=5))

    for label, kern, plain, args, zero_rows in (
        ("K2", table_grad_u10, table_grad_u10_plain, (sorted_idx, perm, wq, dout_bf, n_rows), untouched),
        ("K4-w3", table_grad_w3, table_grad_w3_plain, (sorted_idx, perm, wx, wy, wz, dout, n_rows), untouched),
        ("K4-w3-bf16", table_grad_w3, table_grad_w3_plain, (sorted_idx, perm, *w3_bf, dout_bf, n_rows), untouched),
        ("K4-w8-bf16", table_grad_w8, table_grad_w8_plain, (sorted_idx, perm, w8_bf, dout_bf, n_rows), untouched),
        ("K4-w8", table_grad_w8, table_grad_w8_plain, (sorted_idx, perm, w8, dout, n_rows), untouched),
        ("K5", table_grad_sorted, table_grad_sorted_plain, (sorted_idx, perm, dg, n_rows), untouched),
    ):
        out[label] = held_and_timed(label, kern, plain, args, zero_rows)

    # Every K6 instance: launched by the grouped encoder's own backward at
    # K6_SMALL samples and held there, then held and timed at the grouped
    # train shape (the same points through the encoder, 2^19 samples).
    k6_rng = np.random.default_rng(6)
    for F, split in K6_INSTANCES:
        label = k6_label(F, split)
        launches, small_err = k6_through_the_encoder(dev, F, split, k6_rng)
        args, key, zero_rows = k6_inputs(u, k6_rng, dev, F, split, K6_LOG2T)
        fetches, k6_rows = args[7], args[6]
        nf, jg = len(fetches), len(fetches[0].res)
        print(f"{label} inputs: {n} samples x {nf} fetches over {k6_rows} rows, F = {F}, keys_per_row {split}, "
              f"{jg * F} columns a corner; the encoder's backward at {K6_SMALL} samples launched it {launches} "
              f"time(s), max abs err {small_err:.3e}", flush=True)
        out[label] = held_and_timed(label, table_grad_pos, table_grad_pos_plain, args, zero_rows)
        n_pairs = nf * n
        # A key and jg * F bf16 cotangents a pair, a position a sample, the
        # table written once.
        out[label]["bytes"] = n_pairs * (4 + 2 * jg * F) + n * 3 * 4 + k6_rows * 128 * 4
        # Per pair: each sub-level's fractions and corner weights (about 46
        # operations) and 8 jg F terms of a multiply and an add.
        out[label]["ops"] = n_pairs * (jg * 46 + 8 * jg * F * 2)
        out[label].update(launches=launches, err=max(out[label]["err"], small_err))
        if (F, split) == (2, 4):
            g_key = key
        del args, key, zero_rows
    # K5's library call: index_add_ of the same cotangent into a float32
    # table (the bf16 rows widened to float32 beforehand, outside the time).
    dg_f32, idx_long = dg.float(), idx.long()

    def library():
        return torch.zeros((n_rows, 128), device=dev).index_add_(0, idx_long, dg_f32)

    k5 = table_grad_sorted(sorted_idx, perm, dg, n_rows)
    lib_err = float((library() - k5).abs().max())
    print(f"K5 against index_add_: max abs err {lib_err:.3e}", flush=True)
    if not lib_err <= 1e-5 * float(k5.abs().max()):
        fail(f"K5 disagrees with index_add_: {lib_err}")
    out["K5"]["library_ms"] = time_ms(library)
    del dg_f32, k5

    # K5 once a level (hash_table_lookup_sized, the fused encoder's pallas
    # route): level 1 of the 4 (2^19 sample-levels over its 2^15 rows), held
    # and timed; then one lookup's backward over that level alone (the rows
    # of the other levels zero) and one over all 4 (4 launches).
    span, lvl = n_rows // 4, slice(n, 2 * n)
    l_sorted, l_perm = torch.sort(idx[lvl] - span)
    l_untouched = torch.bincount(idx[lvl].long() - span, minlength=span) == 0
    out["K5-level"] = held_and_timed(
        "K5 (one level)", table_grad_sorted, table_grad_sorted_plain, (l_sorted, l_perm, dg[lvl], span), l_untouched)
    out["K5-level"].update(bytes=n * (4 + 2 * 128) + span * 128 * 4, ops=n * 128)
    l_idx, l_dg = idx[lvl].long() - span, dg[lvl].float()  # the library call's inputs, outside its time
    out["K5-level"]["library_ms"] = time_ms(
        lambda: torch.zeros((span, 128), device=dev).index_add_(0, l_idx, l_dg))
    del l_idx, l_dg
    table = torch.zeros((n_rows, 128), device=dev, requires_grad=True)
    for label, rows, n_levels, base, want in (
        ("level 1 of 4", idx[lvl], 1, 1, table_grad_sorted_plain(l_sorted, l_perm, dg[lvl], span)),
        ("4 levels", idx, 4, 0, table_grad_sorted_plain(sorted_idx, perm, dg, n_rows)),
    ):
        table.grad, before = None, table_grad_sorted.launches
        g = hash_table_lookup_sized(table, rows.long(), compute_dtype=bf, level_span=span, n_levels=n_levels,
                                    level_base=base)
        g.backward(dg[lvl] if n_levels == 1 else dg)
        torch.cuda.synchronize()
        launches, got = table_grad_sorted.launches - before, table.grad
        block = got[base * span : (base + n_levels) * span]
        err = float((block - want).abs().max())
        print(f"hash_table_lookup_sized backward ({label}): K5 launched {launches} time(s), max abs err {err:.3e} "
              f"against its plain version", flush=True)
        if launches != n_levels:
            fail(f"hash_table_lookup_sized ({label}) launched K5 {launches} times, not once a level ({n_levels})")
        if not err <= 1e-5 * float(want.abs().max()):
            fail(f"hash_table_lookup_sized ({label}) disagrees with K5's plain version: {err}")
        if bool(got[: base * span].any()) or bool(got[(base + n_levels) * span :].any()):
            fail(f"hash_table_lookup_sized ({label}) wrote rows outside its levels")
        out["K5-level"]["err"] = max(out["K5-level"]["err"], err)
        del g, got, block, want

    # K4-w8 through hash_lookup_combine: the bf16 combine with the given
    # corner weights, one backward at 2^21 sample-levels, one launch.
    table.grad, before = None, table_grad_w8.launches
    hash_lookup_combine(table, idx.long(), w8, compute_dtype=bf).backward(dout_bf)
    torch.cuda.synchronize()
    launches = table_grad_w8.launches - before
    want = table_grad_w8_plain(sorted_idx, perm, w8_bf, dout_bf, n_rows)
    err = float((table.grad - want).abs().max())
    print(f"hash_lookup_combine backward (bf16, 2^21 sample-levels): K4-w8 launched {launches} time(s), max abs "
          f"err {err:.3e} against its plain version", flush=True)
    if launches != 1 or not err <= 1e-5 * float(want.abs().max()):
        fail(f"hash_lookup_combine: K4-w8 launched {launches} times (not 1) or err {err} against its plain version")
    out["K4-w8-bf16"]["err"] = max(out["K4-w8-bf16"]["err"], err)
    del table, want
    sort_ms = time_ms(lambda: torch.sort(idx))
    table_bytes = n_rows * 128 * 4
    # Bytes each function must move: each input read once (row, weights,
    # cotangent; not the sort's permutation), the table written once.
    for label, per_sample in (
        ("K2", 4 + 4 + 2 * 16), ("K4-w3", 4 + 3 * 4 + 4 * 16), ("K4-w3-bf16", 4 + 3 * 2 + 2 * 16),
        ("K4-w8-bf16", 4 + 8 * 2 + 2 * 16), ("K4-w8", 4 + 8 * 4 + 4 * 16), ("K5", 4 + 2 * 128),
    ):
        out[label]["bytes"] = n_sl * per_sample + table_bytes
        # A multiply and an add per term (K5: an add per element).
        out[label]["ops"] = n_sl * 128 * (1 if label == "K5" else 2)
    n_pairs = g_key.numel()
    for label, o in out.items():
        bound = o["bytes"] / HBM_BYTES_PER_S * 1e3
        print(
            f"{label}: kernel {o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, "
            f"bound {bound:.4f} ms ({o['bytes']} B at 3.35 TB/s), {100 * bound / o['ms']:.1f}% of bound"
            + (f", index_add_ {o['library_ms']:.4f} ms" if "library_ms" in o else ""),
            flush=True,
        )
    for rows in sorted({n_rows} | {F << K6_LOG2T for F, _ in K6_INSTANCES}):  # F spans of 2^16 rows
        print(f"torch.zeros of a ({rows}, 128) float32 output (inside each kernel's time): "
              f"{time_ms(lambda: torch.zeros((rows, 128), device=dev)):.4f} ms", flush=True)
    print(f"torch.sort of {n_sl} int32 rows (outside K2, K4, K5): {sort_ms:.4f} ms", flush=True)
    print(f"quantize_u10 of {n_sl} sample-levels (ahead of K2): "
          f"{time_ms(lambda: quantize_u10(wx, wy, wz)):.4f} ms", flush=True)
    print(f"torch.sort of {n_pairs} int32 (row, fetch) keys (outside K6): "
          f"{time_ms(lambda: torch.sort(g_key)):.4f} ms", flush=True)

    ids, vals = k3_inputs(rng)
    out["K3"] = k3_checked_and_timed("at phase 5's draws", torch.from_numpy(ids).to(dev),
                                     torch.from_numpy(vals).to(dev), 1 << 21, dev)
    return out


def k3_inputs(rng) -> tuple:
    """K3's draws at bench.py's update: 2^20 ids into 2^21 cells, half
    uniform and half from the occupied shell (so cells repeat), values in
    [0, 4e-3] with a cluster at 1e-3, where the TPU kernel's precision trap
    was."""
    n_cells, n_draws = 1 << 21, 1 << 20
    occupied = np.flatnonzero(shell_binaries(128).reshape(-1))
    ids = np.concatenate([
        rng.integers(0, n_cells, n_draws // 2), occupied[rng.integers(0, occupied.size, n_draws // 2)]
    ]).astype(np.int32)
    vals = rng.random(n_draws, dtype=np.float32) * 4e-3
    vals[:4096] = (1e-3 * (1.0 + rng.uniform(-1e-6, 1e-6, 4096))).astype(np.float32)
    return ids, vals


def bench_setup(dev, field_cfg, compute_dtype, weights=None):
    """Phase 6's estimator, shell grid, rays and pixels (bench.py:86,118-122)
    and a field of ``field_cfg`` from seed 0 (or ``weights``), with Adam."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField

    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1, skip_factor=2)
    state = est.set_binaries(est.init(dev), torch.from_numpy(shell_binaries(GRID_RES)))
    field = NGPRadianceField(
        aabb=AABB, compute_dtype=compute_dtype, device=dev, generator=torch.Generator().manual_seed(0), **field_cfg,
    )
    if weights is not None:
        field.load_state_dict(weights)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(TRAIN_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = (torch.from_numpy(-3.0 * d).to(dev), torch.from_numpy(d).to(dev))
    pixels = torch.from_numpy(rng.random((TRAIN_RAYS, 3), dtype=np.float32)).to(dev)
    opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
    return est, state, field, opt, rays, pixels


def train_full_width(dev, field_cfg, grad_kernel, grad_label, profile_name, check_inputs,
                     compute_dtype=torch.bfloat16, details=None):
    """Phases 6, 7, 9 and 15a: bench.py's throughput phase on the port with
    the field ``field_cfg`` at ``compute_dtype`` (None: float32), whose
    table gradient launches ``grad_kernel`` (``grad_label`` in the prints;
    None for an encoder whose gradient is autograd's); then, if
    ``check_inputs``, K1 against its plain version on one step's queries and
    K3 on one update's draws, each timed.  Returns the field (for phase 8),
    the launches of K1, the table-gradient kernel and K3 on the train path,
    and K1's largest difference on those queries (0 when not checked).  A
    dict ``details`` receives K1's and K3's numbers on the path's own inputs
    (``k1``, ``k3``), the profile (``profile``) and the update's ms."""
    from nerfacc_tpu_torch.ops.occ_query import occupancy_query
    from nerfacc_tpu_torch.ops.table_grad import cell_max

    est, state, field, opt, (rays_o, rays_d), pixels = bench_setup(dev, field_cfg, compute_dtype)
    what = f"{field_cfg.get('encoder_type', 'fused')}, {'bf16' if compute_dtype else 'float32'}"
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        jitter = torch.rand((TRAIN_RAYS,), generator=gen, device=dev)
        return train_step(field, opt, est, state, rays_o, rays_d, pixels, jitter, TRAIN_CAPACITY)[:2]

    def update():
        return occ_update(est, state, field, generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    occupancy_query.launches = cell_max.launches = 0
    if grad_kernel is not None:
        grad_kernel.launches = 0
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
    launches = {"K1": occupancy_query.launches, "K3": cell_max.launches}
    if grad_kernel is not None:
        launches[grad_label] = grad_kernel.launches
    total = int(torch.stack(n_samps).sum())
    occupied = int(outs[-1].binaries.sum())
    del outs
    # bench.py: one occupancy update per 16 steps.
    sps = total / (step_time + TRAIN_ITERS / 16.0 * update_time)
    first, last = float(losses[0]), float(losses[-1])
    print(
        f"train ({what}): {sps:.1f} samples/s ({total} samples in "
        f"{TRAIN_ITERS} steps), step {step_time / TRAIN_ITERS * 1e3:.2f} ms, occupancy update "
        f"{update_time * 1e3:.2f} ms, launches "
        + " ".join(f"{k} {v}" for k, v in launches.items())
        + f", max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"loss first {first:.6f} last {last:.6f}, occupied after an update {occupied}",
        flush=True,
    )
    if not all(math.isfinite(float(x)) for x in losses):
        fail("train: a loss is not finite")
    if (launches["K1"] <= 0 or launches.get(grad_label, TRAIN_ITERS) < TRAIN_ITERS
            or launches["K3"] < TRAIN_UPDATES):
        fail(f"train: kernels launched too few times on the train path: {launches}")
    if not 0.5 * TRAIN_CAPACITY * TRAIN_ITERS < total <= TRAIN_CAPACITY * TRAIN_ITERS:
        fail(f"train: {total} samples in {TRAIN_ITERS} steps is not near the capacity")
    k1_err = 0.0
    if check_inputs:
        k1 = k1_on_train_inputs(step, state)
        k3 = k3_on_update_inputs(update, dev)
        k1_err = k1["err"]
        if details is not None:
            details.update(k1=k1, k3=k3)

    def steps_and_update():
        for _ in range(3):
            step()
        update()

    prof = profile_window(
        steps_and_update,
        ("traverse_and_compact", "field_forward", "gather_combine", "rendering", "backward",
         "table_grad", "optimizer", "occ_update"),
        f"train {what} (3 steps and 1 update)", profile_name,
    )
    if details is not None:
        details.update(profile=prof, update_ms=update_time * 1e3, sps=sps)
    return field, launches, k1_err, step_time / TRAIN_ITERS * 1e3


# The gradient tolerance of the entries that a sample whose ReLU input took
# another sign on the card feeds (phase 15c): up to 8.4e-4 of the largest
# entry measured on an H100 (PERF.md).
WIDE_TOL = 3e-3


def hold_step(label, a, b, tol, mlp_tol, what, adam_eps=1e-15, held_tols=0.0, wide=None,
              sides="card vs CPU") -> None:
    """One train step on the card (``a``) against the CPU (``b``), or
    another pair that ``sides`` names, each a dict of the kept-sample count
    ``n``, the ``loss``, the ``grads`` and the ``params`` after Adam (and
    the CPU step's seconds ``s``, printed where given): equal counts, the loss within ``tol`` relative,
    every hash table's gradient within ``tol`` and the others within ``mlp_tol`` of
    their largest value (``WIDE_TOL`` at the entries that a mask in ``wide``
    marks), the parameters held where the gradients' signs
    agree and ``|g|`` is far above Adam's ``adam_eps`` and ``held_tols``
    times the gradient's tolerance (Adam's first step moves a parameter by
    ``lr * g / (|g| + eps)``, which follows ``g`` closely only there; with a
    coupled weight decay ``g`` is ``g + wd p``, given as ``adam_grads``)."""
    if a["n"] != b["n"]:
        fail(f"{sides} ({label}): kept samples {a['n']} vs {b['n']}")
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    worst = {}
    for k, g_cpu in b["grads"].items():
        g_gpu = a["grads"][k]
        k_tol = tol if k == "encoder.table" else mlp_tol
        scale = max(float(g_cpu.abs().max()), 1e-30)
        e_tol = torch.where(wide[k], WIDE_TOL, k_tol) if wide is not None and k in wide else k_tol
        g_tol = torch.as_tensor(e_tol * scale)
        err = (g_gpu - g_cpu).abs()
        worst[k] = float(err.max()) / scale
        # Adam's first step moves a parameter by lr * g / (|g| + eps),
        # about lr * sign(g); a sign may differ only where the gradients
        # agree within g_tol, and the step is held where the signs agree
        # and |g| is far above eps = 1e-15.
        agree = torch.sign(g_gpu) == torch.sign(g_cpu)
        # Adam normalises the gradient with its coupled weight decay added,
        # g + wd p (``adam_grads`` where the step had a decay).
        s_gpu, s_cpu = (d.get("adam_grads", d["grads"])[k] for d in (a, b))
        held = (torch.sign(s_gpu) == torch.sign(s_cpu)) & (
            s_cpu.abs() > torch.clamp(held_tols * g_tol, min=max(1e-9, 100 * adam_eps)))
        p_diff = torch.where(held, a["params"][k] - b["params"][k], 0.0).abs()
        p_err = float(p_diff.max())
        if not bool((err <= g_tol).all()) or not bool((g_cpu.abs() <= g_tol)[~agree].all()) or p_err > 1e-6:
            i = int(p_diff.argmax())
            fail(f"{sides} ({label}): {k} gradient rel err {worst[k]:.3e} (tol {k_tol}"
                 + (f", {WIDE_TOL} at {int(wide[k].sum())} entries" if wide is not None and k in wide else "")
                 + f"), params after Adam err {p_err:.3e} (there: g {float(g_gpu.flatten()[i]):.6e} card, "
                 f"{float(g_cpu.flatten()[i]):.6e} CPU; Adam's g {float(s_gpu.flatten()[i]):.6e}, "
                 f"{float(s_cpu.flatten()[i]):.6e})")
    table = f"table gradient rel err {worst['encoder.table']:.2e} (tol {tol}), " if "encoder.table" in worst else ""
    print(
        f"{sides} train step ({label}, {what}): samples "
        f"{a['n']} = {b['n']}, loss {a['loss']:.7f} vs {b['loss']:.7f} (rel err {loss_err:.2e}), "
        f"{table}worst over parameters {max(worst.values()):.2e} (tol {mlp_tol})"
        + (f"; CPU step {b['s']:.1f} s" if "s" in b else ""),
        flush=True,
    )
    if loss_err > tol:
        fail(f"{sides} ({label}): loss rel err {loss_err} > {tol}")


def ngp_field(cfg: dict, compute_dtype, device):
    """``NGPRadianceField(aabb=AABB, **cfg)``; a ``keys_per_row`` in ``cfg``
    gives its grouped encoder that split (the JAX package's
    ``NERFACC_GROUPED_SPLIT``), on the same table."""
    from nerfacc_tpu_torch.models.hash_soa import HashGridEncoderGrouped
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField

    cfg = dict(cfg)
    keys_per_row = cfg.pop("keys_per_row", None)
    field = NGPRadianceField(aabb=AABB, compute_dtype=compute_dtype, device=device, **cfg)
    if keys_per_row is not None:
        e = field.encoder
        field.encoder = HashGridEncoderGrouped(
            e.n_levels, e.n_features_per_level, e.table_size.bit_length() - 1, keys_per_row=keys_per_row,
            compute_dtype=compute_dtype, device=device,
        )
    return field


def train_card_vs_cpu(dev, fused_state, grouped_state) -> dict:
    """Phase 8: the traversal, then one train step at 1024 rays and 2^15
    samples, full width, on the card and on the CPU, from the same weights,
    jitter and draws, for every table-gradient route (and one occupancy
    update after the float32 fused step).  Returns each route's kernel
    launches in its card step."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.ops import table_grad as tg

    cpu = torch.device("cpu")
    bf = torch.bfloat16
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
    wrappers = ("table_grad_u10", "table_grad_w3", "table_grad_w8", "table_grad_sorted", "table_grad_pos")
    fused, grouped = TRAIN_FIELD_CFG, GROUPED_FIELD_CFG
    # Tolerances, relative to each parameter's largest gradient: float32,
    # 1e-4 for the table (the kernel against its plain version, or the
    # card's atomic index_put_ for the grouped float32 step, and the same
    # upstream float32 math) and 3e-4 for the MLPs, whose gradients are sums
    # over 32k samples that cancel, so the card's and the CPU's last-bit
    # differences in GEMMs and exp/sigmoid grow relative to the result
    # (9.05e-5 to 1.06e-4 measured); bf16, 2e-2 for all
    # (tests/test_models.py:549).
    routes = (
        # (label, field configuration, weights, compute dtype, table tol,
        #  MLP tol, the wrapper that must launch once (K5: once a level), or
        #  None)
        ("float32", fused, fused_state, None, 1e-4, 3e-4, "table_grad_w3"),
        ("bf16", fused, fused_state, bf, 2e-2, 2e-2, "table_grad_u10"),
        ("grouped bf16", grouped, grouped_state, bf, 2e-2, 2e-2, "table_grad_pos"),
        ("grouped float32", grouped, grouped_state, None, 1e-4, 3e-4, None),
        # K6 at the other window widths of the same table: split 2 (jg = 4,
        # 8 columns a corner) and split 8 (jg = 1, 2 columns a corner).
        ("grouped bf16 split 2", dict(grouped, keys_per_row=2), grouped_state, bf, 2e-2, 2e-2, "table_grad_pos"),
        ("grouped bf16 split 8", dict(grouped, keys_per_row=8), grouped_state, bf, 2e-2, 2e-2, "table_grad_pos"),
        ("pallas bf16", dict(fused, table_grad="pallas"), fused_state, bf, 2e-2, 2e-2, "table_grad_sorted"),
        ("w8 bf16", dict(fused, factor_pack="w8"), fused_state, bf, 2e-2, 2e-2, "table_grad_w8"),
        ("w8 float32", dict(fused, factor_pack="w8"), fused_state, None, 1e-4, 3e-4, "table_grad_w8"),
        ("w3 bf16", dict(fused, factor_pack="w3"), fused_state, bf, 2e-2, 2e-2, "table_grad_w3"),
    )
    launches = {}
    for label, cfg, field_state, cdt, tol, mlp_tol, kernel in routes:
        res = []
        for device in (dev, cpu):
            field = ngp_field(cfg, cdt, device)
            field.load_state_dict({k: v.to(device) for k, v in field_state.items()})
            opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
            state = est.set_binaries(est.init(device), shell)
            for w in wrappers:
                getattr(tg, w).launches = 0
            t0 = time.perf_counter()
            loss, n_samp, _ = train_step(
                field, opt, est, state, rays_o.to(device), rays_d.to(device),
                pixels.to(device), jitter.to(device), capacity,
            )
            grads = {k: p.grad.detach().cpu() for k, p in field.named_parameters()}
            params = {k: p.detach().cpu() for k, p in field.named_parameters()}
            new_state = occ_update(est, state, field, draws=draws) if label == "float32" else None
            if device.type == "cuda":
                torch.cuda.synchronize()
                used = {w: getattr(tg, w).launches for w in wrappers}
                per_step = cfg["n_levels"] if kernel == "table_grad_sorted" else 1
                want = {w: per_step * int(w == kernel) for w in wrappers}
                if used != want:
                    fail(f"card vs CPU ({label}): table-gradient launches {used}, expected {want}")
                launches[label] = used.get(kernel, 0)
            res.append(dict(
                loss=float(loss), n=int(n_samp), grads=grads, params=params,
                occs=None if new_state is None else new_state.occs.cpu(),
                binaries=None if new_state is None else new_state.binaries.cpu(),
                s=time.perf_counter() - t0,
            ))
        a, b = res  # card, CPU
        hold_step(label, a, b, tol, mlp_tol, f"{n_rays} rays, capacity {capacity}")
        if b["occs"] is not None:
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
    return launches


def unbounded_rays(rng, n: int, dev) -> tuple:
    """``n`` rays from origins on the unit sphere (the median camera distance
    after ``similarity_from_cameras``, ``nerf_360_v2.py:66-67``), each aimed
    at a point drawn uniformly in +-0.5, and random pixels."""
    o = rng.normal(size=(n, 3))
    o /= np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.5, 0.5, size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pixels = rng.random((n, 3), dtype=np.float32)
    return tuple(torch.from_numpy(np.asarray(a, np.float32)).to(dev) for a in (o, d, pixels))


def unbounded_field(est, dev, weights=None):
    """The phase's field: ``FIELD_CFG`` in float32 on the outer box with the
    scene contraction, random weights from seed 0 (or ``weights``)."""
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField

    field = NGPRadianceField(
        aabb=est._aabbs_np[-1].tolist(), unbounded=True, compute_dtype=None, device=dev,
        generator=torch.Generator().manual_seed(0), **FIELD_CFG,
    )
    if weights is not None:
        field.load_state_dict({k: v.to(dev) for k, v in weights.items()})
    return field


def state_on(state, device):
    """An ``OccGridState`` with every tensor moved to ``device``."""
    import dataclasses

    return state.replace(**{f.name: getattr(state, f.name).to(device) for f in dataclasses.fields(state)})


def eval_render(est, state, field, o, d, record=None) -> tuple:
    """``eval_render`` of ``examples/train_ngp_nerf_occ.py:309-322``: chunks
    of ``UNB_CHUNK`` rays (the last padded with its last ray) through
    ``occgrid_render_rays`` with the visibility filter, 64 samples a ray, no
    stratification, a white background.  Returns the colours, the rendered
    samples and each chunk's ``(kept, ray_indices)``; ``record`` goes to
    :func:`density_fn`."""
    from nerfacc_tpu_torch.rendering import gather_ray_od, occgrid_render_rays

    imgs, total, layouts = [], 0, []
    with torch.no_grad():
        for j in range(0, o.shape[0], UNB_CHUNK):
            oc, dc = o[j : j + UNB_CHUNK], d[j : j + UNB_CHUNK]
            n_real = oc.shape[0]
            if n_real < UNB_CHUNK:
                oc = torch.cat([oc, oc[-1:].expand(UNB_CHUNK - n_real, 3)])
                dc = torch.cat([dc, dc[-1:].expand(UNB_CHUNK - n_real, 3)])

            def rgb_sigma_fn(ts, te, ri, oc=oc, dc=dc):
                oo, dd = gather_ray_od(oc, dc, ri)
                rgb, sigma = field(oo + ((ts + te) / 2)[:, None] * dd, dd)
                return rgb, sigma[..., 0]

            colors, _, _, n_s, extras = occgrid_render_rays(
                rgb_sigma_fn, density_fn(field, oc, dc, record), est, state, oc, dc,
                far_plane=1e10, render_bkgd=torch.ones(3, device=o.device),
                sample_capacity=UNB_CHUNK * 64, **UNB_RENDER_KW,
            )
            imgs.append(colors[:n_real])
            total += n_s
            layouts.append((extras["kept"], extras["ray_indices"]))
    return torch.cat(imgs), int(total), layouts


def same_traversal(label, pa, pb) -> None:
    """The density passes' inputs on the card (``pa``) and the CPU (``pb``),
    each ``(t_starts, t_ends, ray_indices, sigmas)``: the same samples of the
    same rays, t values within 1e-6 of the largest."""
    ts_a, te_a, ri_a = (x.cpu() for x in pa[:3])
    ts_b, te_b, ri_b = pb[:3]
    if not torch.equal(ri_a, ri_b) or not torch.equal(te_a > ts_a, te_b > ts_b):
        fail(f"card vs CPU ({label}): the traversals kept different samples "
             f"({int((te_a > ts_a).sum())} vs {int((te_b > ts_b).sum())})")
    err = max(float((ts_a - ts_b).abs().max()), float((te_a - te_b).abs().max()))
    scale = float(te_b.abs().max())
    if err > 1e-6 * scale:
        fail(f"card vs CPU ({label}): traversal t max abs err {err} > 1e-6 * {scale}")


def alphas_trans(p) -> tuple:
    """``(alphas, trans)`` of a density pass ``p``, as the filter sees them,
    computed on the pass's device and returned on the CPU."""
    from nerfacc_tpu_torch.volrend import render_transmittance_from_density

    ts, te, ri, sigma = p
    trans, alphas = render_transmittance_from_density(ts, te, torch.where(te > ts, sigma, 0.0), ray_indices=ri)
    return alphas.cpu(), trans.cpu()


# alpha = 1 - exp(-sigma dt) in float32, and exp(-sigma dt) lies just below
# 1, where float32 values are 2^-24 apart: alpha moves in steps of 2^-24
# (6.0e-8, 5.5e-5 of a threshold near 1e-3), and the card's exp and the
# CPU's differ by a step now and then.
ALPHA_STEP = 2.0**-24


def threshold_adjacent(at, thre: float, eps: float = 1e-4) -> torch.Tensor:
    """The samples whose alpha (``at = (alphas, trans)`` of the CPU's density
    pass) lies within 1e-5 (relative) and two alpha steps of the filter's
    threshold ``thre``, or whose transmittance lies within 1e-5 of ``eps``:
    there the card's last-bit differences may flip the filter."""
    alphas, trans = at
    return ((alphas - thre).abs() <= 1e-5 * thre + 2 * ALPHA_STEP) | ((trans - eps).abs() <= 1e-5)


def report_flips(label, at_a, at_b, differ, near, thre) -> None:
    """For the samples kept on one side only away from the thresholds: the
    card's and the CPU's alpha and transmittance (the first few)."""
    (a_a, t_a), (a_b, t_b) = at_a, at_b
    bad = torch.nonzero(differ & ~near)[:, 0]
    d = (a_a - a_b)[bad].abs()
    print(f"{label}: {bad.numel()} samples away from the thresholds kept on one side only; "
          f"|alpha card - alpha CPU| there max {float(d.max()):.3e} = {float(d.max()) / ALPHA_STEP:.2f} steps, "
          f"|alpha CPU - threshold| max {float((a_b[bad] - thre).abs().max()):.3e}", flush=True)
    for i in bad[:5].tolist():
        print(f"  sample {i}: alpha card {float(a_a[i]):.9e} CPU {float(a_b[i]):.9e}, threshold {thre:.9e}, "
              f"trans card {float(t_a[i]):.6e} CPU {float(t_b[i]):.6e}", flush=True)


def unbounded_card_vs_cpu(dev, est, state, weights, crop_o, crop_d) -> None:
    """One unbounded train step at 1024 rays and 2^15 samples, full field
    width, on the card and on the CPU from the same weights, jitter and
    occupancy state; then a crop through the eval path.  The traversals
    must agree; the visibility masks may differ only on threshold-adjacent
    samples (:func:`threshold_adjacent`); where they agree, the step is held
    to phase 8's float32 tolerances and the crop to phase 4's atol 1e-4."""
    cpu = torch.device("cpu")
    n_rays, capacity = 1024, 1 << 15
    rng = np.random.default_rng(3)
    rays_o, rays_d, pixels = unbounded_rays(rng, n_rays, cpu)
    jitter = torch.from_numpy(rng.random(n_rays, dtype=np.float32))
    thre = float(state.occs.cpu().mean().clamp(max=UNB_RENDER_KW["alpha_thre"]))
    res = []
    for device in (dev, cpu):
        field = unbounded_field(est, device, weights)
        opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
        st = state_on(state, device)
        ro, rd = rays_o.to(device), rays_d.to(device)
        record = []
        t0 = time.perf_counter()
        loss, n_samp, extras = train_step(
            field, opt, est, st, ro, rd, pixels.to(device), jitter.to(device), capacity,
            UNB_RENDER_KW, density_fn(field, ro, rd, record),
        )
        (p,) = record
        res.append(dict(
            loss=float(loss), n=int(n_samp), kept=extras["kept"].cpu(),
            grads={k: q.grad.detach().cpu() for k, q in field.named_parameters()},
            params={k: q.detach().cpu() for k, q in field.named_parameters()},
            p=tuple(x.detach().cpu() for x in p), at=alphas_trans(p), s=time.perf_counter() - t0,
        ))
    a, b = res
    same_traversal("unbounded step", a["p"], b["p"])
    near = threshold_adjacent(b["at"], thre)
    differ = a["kept"] != b["kept"]
    print(f"card vs CPU unbounded step: threshold {thre:.6e}, {int((b['p'][1] > b['p'][0]).sum())} "
          f"traversed samples, {int(near.sum())} threshold-adjacent, {int(differ.sum())} kept on one side only",
          flush=True)
    if bool((differ & ~near).any()):
        report_flips("card vs CPU unbounded step", a["at"], b["at"], differ, near, thre)
        fail(f"card vs CPU unbounded step: {int((differ & ~near).sum())} samples away from the "
             "thresholds kept on one side only")
    if bool(differ.any()):
        print("card vs CPU unbounded step: the masks differ at threshold-adjacent samples, "
              "so the loss and gradients are not held", flush=True)
    else:
        hold_step("unbounded float32", a, b, 1e-4, 3e-4, f"{n_rays} rays, capacity {capacity}")

    out = []
    for device in (dev, cpu):
        record = []
        t0 = time.perf_counter()
        img, total, layouts = eval_render(
            est, state_on(state, device), unbounded_field(est, device, weights),
            crop_o.to(device), crop_d.to(device), record,
        )
        out.append(dict(img=img.cpu(), total=total, layouts=[(k.cpu(), r.cpu()) for k, r in layouts],
                        p=[tuple(x.cpu() for x in q) for q in record], at=[alphas_trans(q) for q in record],
                        s=time.perf_counter() - t0))
    a, b = out
    exempt = torch.zeros(crop_o.shape[0], dtype=torch.bool)
    n_near = n_differ = 0
    for (ka, _), (kb, rb), pa, pb, at_a, at_b in zip(a["layouts"], b["layouts"], a["p"], b["p"], a["at"], b["at"]):
        same_traversal("crop", pa, pb)
        near = threshold_adjacent(at_b, thre)
        differ = ka != kb
        n_near += int(near.sum())
        n_differ += int(differ.sum())
        if bool((differ & ~near).any()):
            report_flips("card vs CPU crop", at_a, at_b, differ, near, thre)
            fail("card vs CPU crop: samples away from the thresholds kept on one side only")
        # A ray with a sample kept on one side only is not held; the layouts
        # are the traversal's, so both sides name the same rays.
        rays = rb[differ].long()
        exempt[rays[rays < exempt.shape[0]]] = True
    err = float((a["img"] - b["img"])[~exempt].abs().max())
    print(f"card vs CPU crop ({crop_o.shape[0]} rays): samples {a['total']} vs {b['total']}, "
          f"{n_near} threshold-adjacent, {n_differ} kept on one side only ({int(exempt.sum())} rays not held), "
          f"rgb max abs err {err:.3e}; CPU render {b['s']:.1f} s", flush=True)
    if err > 1e-4:
        fail(f"card vs CPU crop: rgb disagrees beyond atol 1e-4: {err}")


def train_unbounded(dev) -> dict:
    """Phase 10: the unbounded float32 NGP-occ train step with the
    visibility filter at full width (``UNB_*``), its occupancy state built
    by the estimator's own updates, then one 800x800 eval view through the
    filter, then the card against the CPU.  Returns the launches of K1,
    K4-w3 and K3 on the train path and K1's and K3's numbers on the phase's
    own inputs."""
    from nerfacc_tpu_torch.datasets.procedural import pose_spherical
    from nerfacc_tpu_torch.datasets.utils import generate_rays
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.ops.occ_query import occupancy_query
    from nerfacc_tpu_torch.ops.table_grad import cell_max, table_grad_w3
    from torch.profiler import record_function

    t_phase = time.perf_counter()
    est = OccGridEstimator(roi_aabb=UNB_ROI, resolution=GRID_RES, levels=UNB_LEVELS, skip_factor=2)
    kw = UNB_RENDER_KW
    plan = est.plan_traversal(kw["render_step_size"], kw["cone_angle"], kw["near_plane"],
                              max_macro_segments=kw["max_macro_segments"])
    print(f"train unbounded: plan (lattice, use_skip, macro_stride, max_macro, row_cap) = {plan}", flush=True)
    field = unbounded_field(est, dev)
    opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
    rays_o, rays_d, pixels = unbounded_rays(np.random.default_rng(0), UNB_RAYS, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    cur = {"state": est.init(dev)}
    record = []
    sigma_fn = density_fn(field, rays_o, rays_d, record)

    def step():
        jitter = torch.rand((UNB_RAYS,), generator=gen, device=dev)
        return train_step(field, opt, est, cur["state"], rays_o, rays_d, pixels, jitter, UNB_CAPACITY,
                          kw, sigma_fn)

    def update(warmup=False):
        # The example's occ_eval_fn: density times the step size.
        with record_function("occ_update"):
            return est._update(
                cur["state"], 0 if warmup else 10**9,
                lambda x: field.query_density(x) * kw["render_step_size"], generator=gen,
            )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    occupancy_query.launches = table_grad_w3.launches = cell_max.launches = 0
    t0 = time.perf_counter()
    cur["state"] = update(warmup=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    # Untrained, the field's density is about exp(-1) everywhere, so every
    # occupancy sits at the mean that sets the filter's threshold; the steps
    # between the updates give the density its spread.
    losses = []
    for _ in range(UNB_STATE_ROUNDS):
        losses += [step()[0] for _ in range(16)]
        cur["state"] = update()
    n_updates = 1 + UNB_STATE_ROUNDS
    thre = float(cur["state"].occs.mean().clamp(max=kw["alpha_thre"]))
    losses += [step()[0] for _ in range(3)]  # warm-up
    torch.cuda.synchronize()
    record.clear()
    t0 = time.perf_counter()
    n_samps, truncs = [], []
    for _ in range(TRAIN_ITERS):
        loss, n_samp, extras = step()
        losses.append(loss)
        n_samps.append(n_samp)
        truncs.append(extras["macro_truncated_frac"])
    torch.cuda.synchronize()
    step_time = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TRAIN_UPDATES):
        cur["state"] = update()
    torch.cuda.synchronize()
    update_time = (time.perf_counter() - t0) / TRAIN_UPDATES
    n_updates += TRAIN_UPDATES
    n_steps = 16 * UNB_STATE_ROUNDS + 3 + TRAIN_ITERS
    launches = {"K1": occupancy_query.launches, "K4-w3": table_grad_w3.launches, "K3": cell_max.launches}
    total = int(torch.stack(n_samps).sum())
    traversed = int(sum(int((te > ts).sum()) for ts, te, _, _ in record))
    record.clear()
    drop = 1.0 - total / max(traversed, 1)
    trunc = float(torch.stack(truncs).mean())
    sps = total / (step_time + TRAIN_ITERS / 16.0 * update_time)
    first, last = float(losses[0]), float(losses[-1])
    print(
        f"train (unbounded, float32): {sps:.1f} samples/s ({total} samples in {TRAIN_ITERS} steps), "
        f"step {step_time / TRAIN_ITERS * 1e3:.2f} ms, occupancy update {update_time * 1e3:.2f} ms "
        f"(warm-up update {warm_s * 1e3:.1f} ms), launches "
        + " ".join(f"{k} {v}" for k, v in launches.items())
        + f" ({n_steps} steps, {n_updates} updates), max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
        f"loss first {first:.6f} last {last:.6f}, threshold {thre:.6e}, the filter dropped {drop:.4f} of "
        f"{traversed} traversed samples, macro_truncated_frac {trunc:.4f}, occupied "
        f"{int(cur['state'].binaries.sum())} of {cur['state'].binaries.numel()} cells",
        flush=True,
    )
    if not all(math.isfinite(float(x)) for x in losses):
        fail("train unbounded: a loss is not finite")
    if not thre > 0.0:
        fail(f"train unbounded: the filter's threshold is {thre}, so the alpha test is inert")
    if not drop > 0.0:
        fail("train unbounded: the visibility filter dropped no traversed sample")
    want = {"K4-w3": n_steps, "K3": UNB_LEVELS * n_updates}
    if launches["K1"] <= 0 or any(launches[k] != v for k, v in want.items()):
        fail(f"train unbounded: launches {launches}, expected K1 > 0 and {want}")
    k1 = k1_on_train_inputs(step, cur["state"])
    k3 = k3_on_update_inputs(update, dev, levels=UNB_LEVELS)

    def steps_and_update():
        for _ in range(3):
            step()
        update()

    profile_window(
        steps_and_update,
        ("traverse_and_compact", "visibility", "field_forward", "gather_combine", "rendering", "backward",
         "table_grad", "optimizer", "occ_update"),
        "train unbounded float32 (3 steps and 1 update)", "profile_train_unbounded.txt",
    )
    record.clear()

    # The eval view: a camera at radius 1, as the scenes are normalised.
    c2w = pose_spherical(math.radians(-30.0), math.radians(-30.0), 1.0)[:3, :4]
    K = np.array([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(WIDTH), np.arange(HEIGHT), indexing="xy")
    rays = generate_rays(xs, ys, K, c2w, device=dev)
    state = cur["state"]
    torch.cuda.synchronize()
    occupancy_query.launches = 0
    t0 = time.perf_counter()
    img, n_eval, _ = eval_render(est, state, field, rays.origins.reshape(-1, 3), rays.viewdirs.reshape(-1, 3))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    eval_k1 = occupancy_query.launches
    print(f"eval unbounded: {WIDTH * HEIGHT} rays in {dt:.3f} s = {WIDTH * HEIGHT / dt:.1f} rays/s, "
          f"{n_eval} samples, K1 launches {eval_k1}", flush=True)
    if eval_k1 <= 0:
        fail("eval unbounded: the eval path never launched K1")
    if not bool(torch.isfinite(img).all()) or not (0.0 <= float(img.min()) and float(img.max()) <= 1.0 + 1e-6):
        fail("eval unbounded: the image is not finite or outside [0, 1]")
    if n_eval <= 0:
        fail("eval unbounded: no sample rendered")

    r0, c0 = (HEIGHT - CROP) // 2, (WIDTH - CROP) // 2
    crop_o = rays.origins[r0 : r0 + CROP, c0 : c0 + CROP].reshape(-1, 3)
    crop_d = rays.viewdirs[r0 : r0 + CROP, c0 : c0 + CROP].reshape(-1, 3)
    weights = {k: v.detach().clone() for k, v in field.state_dict().items()}
    unbounded_card_vs_cpu(dev, est, state, weights, crop_o, crop_d)
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=k1, k3=k3)


def prop_models(dev, weights=None):
    """Phase 11's fields: the radiance field (``FIELD_CFG``, float32,
    contracted) and the two proposal nets, random weights from seed 0 in the
    example's order (``train_ngp_nerf_prop.py:107-131``), or ``weights``
    (one state dict a model)."""
    from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField

    gen = torch.Generator().manual_seed(0)
    field = NGPRadianceField(aabb=PROP_AABB, unbounded=True, compute_dtype=None, device=dev, generator=gen,
                             **FIELD_CFG)
    nets = [NGPDensityField(aabb=PROP_AABB, unbounded=True, max_resolution=mr, device=dev, generator=gen,
                            **PROP_NET_CFG) for mr in PROP_MAX_RES]
    if weights is not None:
        for model, w in zip([field] + nets, weights):
            model.load_state_dict({k: v.to(dev) for k, v in w.items()})
    return field, nets


def prop_render(field, nets, rays_o, rays_d, record=None, **kw):
    """``propnet_render_rays`` with the example's field callbacks
    (``train_ngp_nerf_prop.py:133-159``) and ``PROP_RENDER_KW``; with a list
    ``record``, each proposal level appends its densities."""
    from nerfacc_tpu_torch.estimators.prop_net import PropNetEstimator
    from nerfacc_tpu_torch.rendering import propnet_render_rays

    def points(ts, te):
        return rays_o[:, None] + ((ts + te) / 2.0)[..., None] * rays_d[:, None]

    def rgb_sigma_fn(ts, te):
        x = points(ts, te)
        rgb, sigma = field(x, rays_d[:, None].expand(x.shape))
        return rgb, sigma[..., 0]

    def prop_fn(net):
        def sigma_fn(ts, te):
            sigma = net(points(ts, te))[..., 0]
            if record is not None:
                record.append(sigma.detach())
            return sigma

        return sigma_fn

    return propnet_render_rays(
        rgb_sigma_fn, [prop_fn(net) for net in nets], PropNetEstimator(), rays_o, rays_d,
        render_bkgd=torch.ones(3, device=rays_o.device), **PROP_RENDER_KW, **kw,
    )


def prop_step(field, nets, opts, rays_o, rays_d, pixels, requires_grad, record=None, **draw_kw):
    """One step of the example's loop (``train_ngp_nerf_prop.py:161-188``):
    render, Huber loss plus the proposal loss, one backward, the field's
    Adam, and the proposal nets' Adam only when ``requires_grad`` (their
    gradients are cleared to None every step).  Returns the loss, the
    proposal loss and the renderer's extras."""
    from nerfacc_tpu_torch.estimators.prop_net import PropNetEstimator
    from torch.profiler import record_function

    colors, _, _, extras = prop_render(field, nets, rays_o, rays_d, record, stratified=True,
                                       requires_grad=requires_grad, **draw_kw)
    loss = torch.nn.functional.huber_loss(colors, pixels, delta=1.0)
    with record_function("prop_loss"):
        prop_loss = PropNetEstimator().compute_loss(extras["prop_cache"], extras["trans"])
    opt_field, opt_prop = opts
    opt_field.zero_grad(set_to_none=True)
    opt_prop.zero_grad(set_to_none=True)
    with record_function("backward"):
        (loss + prop_loss).backward()
    with record_function("optimizer"):
        opt_field.step()
        if requires_grad:
            opt_prop.step()
    return loss.detach(), prop_loss.detach(), extras


def prop_optimizers(field, nets):
    return (torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15),
            torch.optim.Adam([p for net in nets for p in net.parameters()], lr=1e-2, eps=1e-15))


def prop_state(field, nets) -> dict:
    """Gradients and parameters of the field and the proposal nets (the
    nets' names prefixed ``prop<i>.``), on the CPU."""
    named = list(field.named_parameters())
    named += [(f"prop{i}.{k}", v) for i, net in enumerate(nets) for k, v in net.named_parameters()]
    return dict(
        grads={k: v.grad.detach().cpu() for k, v in named if v.grad is not None},
        params={k: v.detach().cpu() for k, v in named},
    )


def ulps_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in float32 steps between ``a`` and ``b``
    (finite, same sign)."""
    ia, ib = a.contiguous().view(torch.int32).long(), b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max()) if a.numel() else 0


# Given the same densities, the card's exp and cumsum put each level's cdf
# an ulp or two (of 1) from the CPU's, and resampling scales that by the
# inverse cdf's slope, the width of a bin in s over its mass: s values 1.01e-6
# apart were measured on the card test's 64 bins (tests/test_torch_cuda.py),
# so atol 1e-5 (PERF.md §6, PR 10).
PROP_S_ATOL = 1e-5
# The chained card and CPU steps resample from densities a few ulps apart
# (PERF.md §6, PR 10), and their s values drift apart level by level (up
# to 5.64e-4 at the last).  The loss is held to rtol 1e-3, as the
# JAX-against-port step on the CPU (2.52e-6 to 6.02e-5 over seven runs).
# The proposal loss follows the edges themselves, which bins each envelope
# covers: 5.70e-5 to 9.35e-4 over seven runs whose trained weights differ
# in their last bits (the card's backward adds in no fixed order), so
# rtol 1e-2.
PROP_CHAINED_RTOL, PROP_CHAINED_PROP_RTOL = 1e-3, 1e-2


def prop_card_vs_cpu(dev, weights) -> None:
    """One prop step at 1024 rays on the card and on the CPU, from the same
    weights and draws, ``requires_grad=True``, held in stages: the s values
    of every level given the card's densities (``PROP_S_ATOL``); the step
    on the card's samples (the t ladder to 0 ulps, phase 8's float32
    tolerances on the gradients and the parameters after Adam, the
    proposal nets' tables at the MLPs' 3e-4: their gradients come through
    the proposal loss, whose terms cancel, and autograd's scatter, 1.39e-4
    measured in tests/test_torch_cuda.py); the chained CPU step (finite,
    losses within ``PROP_CHAINED_RTOL`` and ``PROP_CHAINED_PROP_RTOL``)."""
    import nerfacc_tpu_torch.estimators.prop_net as prop_mod
    from nerfacc_tpu_torch.data_specs import RayIntervals, RaySamples
    from nerfacc_tpu_torch.ops import table_grad as tg

    cpu = torch.device("cpu")
    n_rays = 1024
    n_levels = len(PROP_RENDER_KW["prop_samples"])
    rng = np.random.default_rng(4)
    rays_o, rays_d, pixels = unbounded_rays(rng, n_rays, cpu)
    jitter = [torch.from_numpy(rng.random((n_rays, 1), dtype=np.float32)) for _ in range(n_levels + 1)]
    sampling = prop_mod.importance_sampling
    wrappers = ("table_grad_u10", "table_grad_w3", "table_grad_w8", "table_grad_sorted", "table_grad_pos")

    def step_on(device, replay=None):
        field, nets = prop_models(device, weights)
        edges, record = [], []

        def recording(*a, **k):
            intervals, samples = sampling(*a, **k)
            edges.append(intervals.vals.detach().cpu())
            return intervals, samples

        def replayed(*a, **k):
            s_vals = replay[len(edges)].to(device)
            edges.append(s_vals.cpu())
            return RayIntervals(vals=s_vals), RaySamples(vals=(s_vals[:, 1:] + s_vals[:, :-1]) / 2)

        for w in wrappers:
            getattr(tg, w).launches = 0
        prop_mod.importance_sampling = recording if replay is None else replayed
        t0 = time.perf_counter()
        try:
            loss, prop_loss, extras = prop_step(
                field, nets, prop_optimizers(field, nets), rays_o.to(device), rays_d.to(device),
                pixels.to(device), True, record, jitter=[j.to(device) for j in jitter],
            )
        finally:
            prop_mod.importance_sampling = sampling
        if device.type == "cuda":
            torch.cuda.synchronize()
            used = {w: getattr(tg, w).launches for w in wrappers}
            want = {w: int(w == "table_grad_w3") for w in wrappers}
            if used != want:
                fail(f"card vs CPU (prop): table-gradient launches {used}, expected {want}")
        return dict(
            loss=float(loss), prop_loss=float(prop_loss), n=int(extras["t_starts"].numel()), edges=edges,
            densities=[r.cpu() for r in record], t=extras["t_starts"].detach().cpu(),
            s=time.perf_counter() - t0, **prop_state(field, nets),
        )

    a = step_on(dev)
    # 1. Sampling on the CPU given the card's densities.
    fed = iter(a["densities"])
    _, _, cache = prop_mod.PropNetEstimator().sampling(
        [lambda ts, te: next(fed)] * n_levels, list(PROP_RENDER_KW["prop_samples"]),
        PROP_RENDER_KW["num_samples"], n_rays, PROP_RENDER_KW["near_plane"], PROP_RENDER_KW["far_plane"],
        PROP_RENDER_KW["sampling_type"], stratified=True, requires_grad=True, jitter=jitter, device=cpu,
    )
    s_err = [float((c[0] - e).abs().max()) for c, e in zip(cache, a["edges"])]
    print(f"card vs CPU prop sampling given the card's densities: s max abs err by level {s_err} "
          f"(atol {PROP_S_ATOL})", flush=True)
    if max(s_err) > PROP_S_ATOL:
        fail(f"card vs CPU prop sampling: s values {s_err} beyond atol {PROP_S_ATOL}")
    # 2. The step on the card's samples.
    b = step_on(cpu, replay=a["edges"])
    ulps = ulps_apart(a["t"], b["t"])
    print(f"card vs CPU prop t ladder on the same s: {ulps} ulps apart at most", flush=True)
    if ulps > 0:
        fail(f"card vs CPU prop: the lindisp t ladder differs by {ulps} ulps on the same s")
    hold_step("prop float32", a, b, 1e-4, 3e-4, f"{n_rays} rays, {PROP_RENDER_KW['num_samples']} samples a ray")
    if abs(a["prop_loss"] - b["prop_loss"]) > 1e-4 * abs(b["prop_loss"]):
        fail(f"card vs CPU prop: proposal loss {a['prop_loss']} vs {b['prop_loss']}")
    # 3. The chained CPU step.
    c = step_on(cpu)
    finite = all(bool(torch.isfinite(v).all()) for v in list(c["params"].values()) + [c["t"]])
    s_chain = [float((x - y).abs().max()) for x, y in zip(a["edges"], c["edges"])]
    t_rel = float(((a["t"] - c["t"]) / c["t"]).abs().max())
    loss_rel = abs(a["loss"] - c["loss"]) / abs(c["loss"])
    prop_rel = abs(a["prop_loss"] - c["prop_loss"]) / max(abs(c["prop_loss"]), 1e-30)
    print(f"card vs CPU prop chained step: s max abs err by level {s_chain}, t max rel err {t_rel:.3e}, "
          f"loss {a['loss']:.7f} vs {c['loss']:.7f} (rel {loss_rel:.2e}), proposal loss {a['prop_loss']:.7e} vs "
          f"{c['prop_loss']:.7e} (rel {prop_rel:.2e}); CPU step {c['s']:.1f} s", flush=True)
    if not finite or not math.isfinite(c["loss"]):
        fail("card vs CPU prop chained step: a value is not finite")
    if loss_rel > PROP_CHAINED_RTOL or prop_rel > PROP_CHAINED_PROP_RTOL:
        fail(f"card vs CPU prop chained step: losses beyond rtol {PROP_CHAINED_RTOL} (loss) or "
             f"{PROP_CHAINED_PROP_RTOL} (proposal loss)")


def plain_summed_in_float64(plain, args):
    """``plain(*args)`` with its sum of terms (``table_grad._sum_terms``)
    taken in float64: the same float32 (or bf16) terms, added without the
    float32 rounding of each partial sum, which both the kernel and the
    plain version's ``index_add_`` carry, each in its own order."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    sum_terms = tg._sum_terms

    def in_float64(sorted_idx, w8, d, n_rows):
        terms = (w8.float()[:, :, None] * d.float()[:, None, :]).to(d.dtype).double()
        out = torch.zeros((n_rows, tg.ROW_WIDTH), dtype=torch.float64, device=d.device)
        return out.index_add_(0, sorted_idx.long(), terms.reshape(-1, tg.ROW_WIDTH))

    tg._sum_terms = in_float64
    try:
        return plain(*args)
    finally:
        tg._sum_terms = sum_terms


def grad_kernel_on_step_inputs(label, name, step, what) -> dict:
    """The table-gradient kernel ``ops.table_grad.<name>`` (``label`` in the
    prints) against its plain version on the inputs of one ``step()`` (the
    sorted rows, weights and cotangent as the fused encoder's backward
    passes them): within 1e-5 of the largest row sum of the plain version's
    terms summed in float64 (:func:`plain_summed_in_float64`; a row of a
    trained field's coarse level sums tens of thousands of terms that
    cancel, where any float32 order, the plain version's ``index_add_``
    too, rounds to about 1e-5 of the largest row), the float32 plain
    version's own distances printed beside it; then its time, the plain
    version's, and the bytes and operations of its bound, as phase 5 counts
    them: each input read once but the sort's permutation, the table written
    once, a multiply and an add a term."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    kernel, plain, calls = getattr(tg, name), getattr(tg, name + "_plain"), []

    def recording(*args):
        calls.append(args)
        return kernel(*args)

    # The wrapper counts its launches under its module name, now this one's.
    recording.launches = 0
    setattr(tg, name, recording)
    try:
        step()
        torch.cuda.synchronize()
    finally:
        setattr(tg, name, kernel)
        kernel.launches += recording.launches
    if len(calls) != 1:
        fail(f"{label} on {what}: expected one call, saw {len(calls)}")
    args = calls[0]
    got, want, exact = kernel(*args), plain(*args), plain_summed_in_float64(plain, args)
    torch.cuda.synchronize()
    err, scale = float((got.double() - exact).abs().max()), float(exact.abs().max())
    err32, plain_err = float((got - want).abs().max()), float((want.double() - exact).abs().max())
    n_sl, n_rows = args[0].numel(), args[-1]
    untouched = torch.bincount(args[0].long(), minlength=n_rows) == 0
    print(f"{label} on {what}: {n_sl} sample-levels over {n_rows} rows, {int((~untouched).sum())} rows "
          f"named, max abs err {err:.3e} against plain summed in float64 (largest row sum {scale:.3e}); "
          f"against the float32 plain version {err32:.3e}, which is itself {plain_err:.3e} from the float64 sum",
          flush=True)
    if not err <= 1e-5 * scale:
        fail(f"{label} disagrees with its plain version on {what}: {err} > 1e-5 * {scale}")
    if bool(got[untouched].any()):
        fail(f"{label} wrote rows that no sample names on {what}")
    inputs = [a for i, a in enumerate(args[:-1]) if i != 1]  # all but the permutation
    o = dict(err=err, ms=time_ms(lambda: kernel(*args)), plain_ms=time_ms(lambda: plain(*args), calls=5),
             bytes=sum(a.numel() * a.element_size() for a in inputs) + n_rows * 128 * 4, ops=n_sl * 128 * 2)
    bound = o["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"{label} on {what}: kernel {o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, bound {bound:.4f} ms "
          f"({o['bytes']} B at 3.35 TB/s), {100 * bound / o['ms']:.1f}% of bound", flush=True)
    return o


def train_prop(dev) -> dict:
    """Phase 11: the Mip-NeRF 360 proposal-network train step at full width
    (``PROP_*``), timed at the steady cadence of proposal updates, each
    variant timed alone; K4-w3 on the step's own inputs; a profile window;
    one 800x800 eval view; then one step card against CPU.  Returns K4-w3's
    launches on the train path and its numbers on the step's inputs."""
    from nerfacc_tpu_torch.datasets.procedural import pose_spherical
    from nerfacc_tpu_torch.datasets.utils import generate_rays
    from nerfacc_tpu_torch.estimators.prop_net import get_proposal_requires_grad_fn
    from nerfacc_tpu_torch.ops import table_grad as tg
    from nerfacc_tpu_torch.ops.occ_query import occupancy_query

    t_phase = time.perf_counter()
    field, nets = prop_models(dev)
    opts = prop_optimizers(field, nets)
    rays_o, rays_d, pixels = unbounded_rays(np.random.default_rng(0), PROP_RAYS, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    requires_grad_fn = get_proposal_requires_grad_fn()
    for step_no in range(PROP_START_STEP):  # the cadence's state at step 1000
        requires_grad_fn(step_no)
    counted = {"K4-w3": tg.table_grad_w3, "K2": tg.table_grad_u10, "K1": occupancy_query, "K3": tg.cell_max,
               "K6": tg.table_grad_pos, "K4-w8": tg.table_grad_w8, "K5": tg.table_grad_sorted}

    def step(requires_grad):
        return prop_step(field, nets, opts, rays_o, rays_d, pixels, requires_grad, generator=gen)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for wrapper in counted.values():
        wrapper.launches = 0
    losses, prop_losses = [], []
    # Warm-up: one step of each variant (the first proposal update creates
    # its Adam state and its backward's buffers), then the cadence's.
    for rg in (True, False, requires_grad_fn(PROP_START_STEP)):
        loss, prop_loss, _ = step(rg)
        losses.append(loss)
        if rg:
            prop_losses.append(prop_loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cadence = [requires_grad_fn(PROP_START_STEP + 1 + i) for i in range(TRAIN_ITERS)]
    for rg in cadence:
        loss, prop_loss, _ = step(rg)
        losses.append(loss)
        if rg:
            prop_losses.append(prop_loss)
    torch.cuda.synchronize()
    step_time = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counted.items()}
    peak = torch.cuda.max_memory_allocated()
    variant_ms = {}
    for rg in (True, False):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(PROP_VARIANT_ITERS):
            step(rg)
        torch.cuda.synchronize()
        variant_ms[rg] = (time.perf_counter() - t1) / PROP_VARIANT_ITERS * 1e3
    n_steps = 3 + TRAIN_ITERS
    rays_s = PROP_RAYS * TRAIN_ITERS / step_time
    print(
        f"train prop (unbounded, float32): {rays_s:.1f} rays/s, "
        f"{rays_s * PROP_RENDER_KW['num_samples']:.1f} radiance samples/s, step {step_time / TRAIN_ITERS * 1e3:.2f} ms "
        f"({sum(cadence)} of {TRAIN_ITERS} timed steps update the proposal nets); alone: requires_grad True "
        f"{variant_ms[True]:.2f} ms, False {variant_ms[False]:.2f} ms a step; launches "
        + " ".join(f"{k} {v}" for k, v in launches.items())
        + f" ({n_steps} steps), max_memory_allocated {peak} B, loss first {float(losses[0]):.6f} last "
        f"{float(losses[-1]):.6f}, proposal loss first {float(prop_losses[0]):.6e} last {float(prop_losses[-1]):.6e}",
        flush=True,
    )
    if not all(math.isfinite(float(x)) for x in losses + prop_losses):
        fail("train prop: a loss is not finite")
    want = dict.fromkeys(counted, 0)
    want["K4-w3"] = n_steps
    if launches != want:
        fail(f"train prop: launches {launches}, expected {want}")
    k4 = grad_kernel_on_step_inputs("K4-w3", "table_grad_w3", lambda: step(True), "the prop step")

    def steps():  # one proposal update and two steps without, as the cadence runs
        for rg in (True, False, False):
            step(rg)

    profile_window(
        steps,
        ("prop_sampling", "field_forward", "gather_combine", "rendering", "prop_loss", "backward", "table_grad",
         "optimizer"),
        "train prop float32 (3 steps, one proposal update)", "profile_train_prop.txt",
    )

    # The eval view (train_ngp_nerf_prop.py:191-197, :206-223): a camera at
    # radius 1, 8192-ray chunks, the last padded with its last ray.
    c2w = pose_spherical(math.radians(-30.0), math.radians(-30.0), 1.0)[:3, :4]
    K = np.array([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(WIDTH), np.arange(HEIGHT), indexing="xy")
    rays = generate_rays(xs, ys, K, c2w, device=dev)
    o, d = rays.origins.reshape(-1, 3), rays.viewdirs.reshape(-1, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imgs = []
    with torch.no_grad():
        for j in range(0, o.shape[0], PROP_CHUNK):
            oc, dc = o[j : j + PROP_CHUNK], d[j : j + PROP_CHUNK]
            n_real = oc.shape[0]
            if n_real < PROP_CHUNK:
                oc = torch.cat([oc, oc[-1:].expand(PROP_CHUNK - n_real, 3)])
                dc = torch.cat([dc, dc[-1:].expand(PROP_CHUNK - n_real, 3)])
            colors, _, _, _ = prop_render(field, nets, oc, dc, stratified=False, requires_grad=False)
            imgs.append(colors[:n_real])
    img = torch.cat(imgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"eval prop: {WIDTH * HEIGHT} rays in {dt:.3f} s = {WIDTH * HEIGHT / dt:.1f} rays/s, "
          f"{WIDTH * HEIGHT * PROP_RENDER_KW['num_samples']} radiance samples", flush=True)
    if not bool(torch.isfinite(img).all()) or not (0.0 <= float(img.min()) and float(img.max()) <= 1.0 + 1e-6):
        fail("eval prop: the image is not finite or outside [0, 1]")

    weights = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in [field] + nets]
    prop_card_vs_cpu(dev, weights)
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches["K4-w3"], k4=k4)


def quality_run(dev, train_ds, seed: int):
    """Phase 12's run (``QUALITY_*``) as the occupancy CLI's ``Run``: the
    field seeded as the other phases seed theirs, constant Adam at 1e-2, no
    weight decay, the macro budget held at 24 (bench.py escalates nothing)."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli

    cfg = occ_cli.build_config("procedural")
    cfg.update(
        aabb=np.array([-1, -1, -1, 1, 1, 1], np.float32), grid_resolution=QUALITY_GRID_RES,
        render_step_size=QUALITY_STEP, target_sample_batch_size=QUALITY_RAYS * 32,
        weight_decay=0.0, near_plane=train_ds.near, far_plane=train_ds.far,
    )
    est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=QUALITY_GRID_RES, levels=1)
    field = occ_cli.make_field(cfg, est, device=dev, generator=torch.Generator().manual_seed(seed), **QUALITY_FIELD)
    return occ_cli.Run(
        cfg=cfg, field=field, estimator=est, occ_state=est.init(dev), opt=occ_cli.make_optimizer(field, 0.0),
        schedule=lambda count: 1e-2, generator=torch.Generator(device=dev).manual_seed(seed),
        max_macro=QUALITY_MACRO, max_macro_cap=QUALITY_MACRO,
    )


def native_against_numpy(label, train, run, steps=32) -> dict:
    """The ms of a late step with the loader's training batches from the
    native sampler and from the numpy path (``NATIVE_SAMPLER``), in turns
    (native, numpy, numpy, native), ``steps`` steps each (two updates),
    host clock ending in a synchronize."""
    from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader

    ms = {True: [], False: []}
    for native in (True, False, False, True):
        SubjectLoader.NATIVE_SAMPLER = native
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train(run.step + steps)
            torch.cuda.synchronize()
        finally:
            SubjectLoader.NATIVE_SAMPLER = True
        ms[native].append((time.perf_counter() - t0) / steps * 1e3)
    out = dict(native_ms=float(np.mean(ms[True])), numpy_ms=float(np.mean(ms[False])))
    print(f"{label}: a step {out['native_ms']:.2f} ms with the native sampler's batches, {out['numpy_ms']:.2f} ms "
          f"with the numpy path's ({steps} steps a turn: native {ms[True]}, numpy {ms[False]})", flush=True)
    return out


def train_quality(dev, card_line: str) -> dict:
    """Phase 12: the port's first trained scene.  Generates bench.py's
    quality dataset on the card (timed; a 32x32 crop of one training view
    against the CPU), trains it through the occupancy CLI's ``train`` with
    an eval of the test view every 250 steps, holds K2 and K1 against their
    plain versions on two late steps' own inputs, evaluates PSNR, SSIM,
    MS-SSIM and LPIPS, serves the test view through the render CLI, saves a
    checkpoint, restores it and renders the view again.  Returns the
    launches on the train path, K1's and K2's numbers on the steps' inputs,
    the late step's ms and the serve rays/s."""
    import shutil
    from pathlib import Path

    from nerfacc_tpu_torch.datasets.procedural import intrinsics, make_loaders, render_pixels
    from nerfacc_tpu_torch.examples import render as render_cli
    from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ_cli
    from nerfacc_tpu_torch.examples.common import eval_metrics, psnr

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_ds, test_ds = make_loaders(num_rays=QUALITY_RAYS, width=QUALITY_SIZE, height=QUALITY_SIZE,
                                     n_train=QUALITY_TRAIN_VIEWS, n_test=1, detail=1.0, device=dev)
    gen_s = time.perf_counter() - t0
    n_views = QUALITY_TRAIN_VIEWS + 1
    print(f"quality data: {n_views} views of {QUALITY_SIZE}x{QUALITY_SIZE} generated on the card in {gen_s:.2f} s "
          f"({n_views * QUALITY_SIZE ** 2 * 512 / gen_s:.1f} scene samples/s)", flush=True)
    # A crop of training view 0 through the scene's centre, on the CPU.
    r0 = c0 = (QUALITY_SIZE - QUALITY_CROP) // 2
    ys, xs = np.mgrid[r0 : r0 + QUALITY_CROP, c0 : c0 + QUALITY_CROP]
    crop_cpu = render_pixels(train_ds.camtoworlds[0], intrinsics(QUALITY_SIZE, QUALITY_SIZE), xs.reshape(-1),
                             ys.reshape(-1), detail=1.0, device="cpu").reshape(QUALITY_CROP, QUALITY_CROP, 4)
    crop_card = train_ds.images[0, r0 : r0 + QUALITY_CROP, c0 : c0 + QUALITY_CROP]
    diff = np.abs(crop_card.astype(np.int32) - crop_cpu.astype(np.int32))
    print(f"quality data, card vs CPU on a {QUALITY_CROP}x{QUALITY_CROP} crop of train view 0: "
          f"{100 * (diff > 0).mean():.3f}% of uint8 values differ, by at most {diff.max()}; "
          f"crop alpha mean {crop_cpu[..., 3].mean():.1f}", flush=True)
    if diff.max() > 1:
        fail(f"quality data: the card's view differs from the CPU's by {diff.max()} uint8 steps")

    # Warm-up on a throwaway run (cuBLAS handles, the allocator), as
    # bench.py compiles before its clock starts.
    occ_cli.train(quality_run(dev, train_ds, seed=1), train_ds, 2)
    run = quality_run(dev, train_ds, seed=0)
    test = test_ds[0]
    _, use_skip, *_ = run.estimator.plan_traversal(QUALITY_STEP, 0.0, train_ds.near,
                                                  max_macro_segments=QUALITY_MACRO)
    k1_per_step = 1 + int(use_skip)  # the lattice queries, and the skip probes
    counted = counted_kernels()
    launches = dict.fromkeys(counted, 0)

    def timed_train(until):
        """Train to ``until``; returns the losses, sample counts and seconds,
        and adds the launches to ``launches``."""
        before = {k: w.launches for k, w in counted.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses, n_samp = occ_cli.train(run, train_ds, until)
        torch.cuda.synchronize()
        for k, w in counted.items():
            launches[k] += w.launches - before[k]
        return losses, n_samp, time.perf_counter() - t

    def evaluate():
        with torch.no_grad():
            img = occ_cli.render_image(run, test["rays"], QUALITY_EVAL_CHUNK)
        return img, psnr(img, test["pixels"])

    torch.cuda.reset_peak_memory_stats()
    losses, n_samps, evals = [], [], []
    train_s, reached, late_ms = 0.0, None, None
    while run.step < QUALITY_MAX_STEPS and train_s < QUALITY_BUDGET_S:
        seg_start = run.step
        seg_end = min(seg_start + QUALITY_EVAL_EVERY, QUALITY_MAX_STEPS)
        # Steps 16k+1 to 16k+15 of the segment run alone on the clock: no
        # occupancy update among them.
        w0 = (seg_end - 16) // 16 * 16 + 1
        seg_samples = []
        for part, until in enumerate((w0, w0 + 15, seg_end)):
            seg_losses, seg_n, dt = timed_train(until)
            train_s += dt
            losses += seg_losses
            seg_samples += seg_n
            if part == 1:
                late_ms = dt / 15 * 1e3
        n_samps += seg_samples
        _, p = evaluate()
        spr = float(torch.stack(seg_samples).float().mean()) / QUALITY_RAYS
        occupied = float(run.occ_state.binaries.float().mean())
        evals.append(dict(step=run.step, psnr=p, train_s=train_s, samples_per_ray=spr, occupied=occupied))
        print(f"quality: step={run.step} psnr={p:.4f} train_s={train_s:.3f} samples/ray {spr:.2f} "
              f"(this segment's steps) occupied cells {100 * occupied:.2f}%", flush=True)
        if reached is None and p >= QUALITY_TARGET_DB:
            reached = dict(train_s=train_s, steps=run.step)
    n_timed = run.step
    peak = torch.cuda.max_memory_allocated()
    total_samples = int(torch.stack(n_samps).sum())
    if not all(math.isfinite(float(x)) for x in losses):
        fail("quality: a loss is not finite")
    want = dict.fromkeys(counted, 0)
    want.update(K1=k1_per_step * n_timed, K2=n_timed)
    if launches != want:
        fail(f"quality: launches {launches} over {n_timed} steps, expected {want}")
    # One more step, recorded: K2 on its own inputs (outside the clock).
    profile_window(
        lambda: occ_cli.train(run, train_ds, run.step + 3),
        ("fetch", "traverse_and_compact", "field_forward", "gather_combine", "rendering", "backward", "table_grad",
         "optimizer", "occ_update"),
        f"quality (3 steps from step {run.step})", "profile_train_quality.txt",
    )
    # Two more steps, recorded (outside the clock): K2 and K1 on their own
    # inputs.
    k2 = grad_kernel_on_step_inputs("K2", "table_grad_u10", lambda: occ_cli.train(run, train_ds, run.step + 1),
                                    f"the quality run's step {run.step}")
    k1 = k1_on_train_inputs(lambda: occ_cli.train(run, train_ds, run.step + 1), run.occ_state)
    img, _ = evaluate()
    if not bool(torch.isfinite(img).all()) or not (0.0 <= float(img.min()) and float(img.max()) <= 1.0):
        fail("quality: the eval image is not finite or outside [0, 1]")
    m = eval_metrics(img, test["pixels"])
    print(json.dumps({"quality": {
        "card": card_line, "steps_timed": n_timed, "steps": run.step, "train_s": train_s,
        "psnr_target_db": QUALITY_TARGET_DB, "time_to_target_s": reached and reached["train_s"],
        "steps_to_target": reached and reached["steps"], "final": m,
        "samples_per_s": total_samples / train_s, "late_step_ms": late_ms, "peak_bytes": peak,
        "first_eval": evals[0], "last_eval": evals[-1], "k1_per_step": k1_per_step,
        "launches": {"K1": launches["K1"], "K2": launches["K2"]}, "data_gen_s": gen_s,
    }}), flush=True)
    print(f"quality: {'reached' if reached else 'did not reach'} {QUALITY_TARGET_DB} dB"
          + (f" in {reached['train_s']:.3f} s of train time, {reached['steps']} steps" if reached else "")
          + f"; final PSNR {m['psnr']:.4f} SSIM {m['ssim']:.4f} MS-SSIM {m['ms_ssim']:.4f} "
          f"LPIPS({m['lpips_src']}) {m['lpips']:.4f} after {run.step} steps; {total_samples / train_s:.1f} kept "
          f"samples/s over {train_s:.3f} s; late step {late_ms:.2f} ms; K1 {launches['K1']} "
          f"({k1_per_step} a step), K2 {launches['K2']}; max_memory_allocated {peak} B", flush=True)
    if m["psnr"] < QUALITY_GATE_DB:
        fail(f"quality: final PSNR {m['psnr']:.3f} dB is under {QUALITY_GATE_DB} dB")

    # Serve the trained grid through the render CLI, then the checkpoint
    # round trip: save, restore into new models, render again.
    kw = dict(near=test_ds.near, far=test_ds.far, render_step_size=QUALITY_STEP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served, n_served = render_cli.render_view(run.field, run.estimator, run.occ_state, test["rays"], **kw)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    print(f"quality serve (render CLI, trained grid): {QUALITY_SIZE ** 2 / serve_s:.1f} rays/s, {n_served} samples "
          f"({n_served / QUALITY_SIZE ** 2:.2f} a ray), PSNR {psnr(served, test['pixels']):.4f}", flush=True)
    ckpt = Path("build") / "chip_smoke_quality_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    occ_cli.save(run, str(ckpt), run.step)
    field, est, occ_state, step = render_cli.load_model(str(ckpt), device=dev, **QUALITY_FIELD)
    # The renderer's index_add_ sums in the order its atomics land; both
    # renders of the round trip take the deterministic order.
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        before, _ = render_cli.render_view(run.field, run.estimator, run.occ_state, test["rays"], **kw)
        after, _ = render_cli.render_view(field, est, occ_state, test["rays"], **kw)
    finally:
        torch.use_deterministic_algorithms(False)
    rt_err = float((after - before).abs().max())
    print(f"quality checkpoint: step {step} restored from {ckpt}; the restored models render the test view "
          f"within {rt_err:.3e} of the saved ones (the non-deterministic and deterministic renders before saving "
          f"differ by {float((served - before).abs().max()):.3e})", flush=True)
    if step != run.step or not rt_err <= 1e-6:
        fail(f"quality checkpoint: step {step} of {run.step}, render differs by {rt_err}")
    shutil.rmtree(ckpt, ignore_errors=True)
    native_against_numpy("quality", lambda until: occ_cli.train(run, train_ds, until), run)
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=k1, k2=k2, late_step_ms=late_ms, serve_rays_s=QUALITY_SIZE ** 2 / serve_s)


def mlp_run(cli, cfg, field, dev, seed=0):
    """A ``Run`` of the MLP CLIs (``train_mlp_nerf.Run``) for ``field`` on a
    fresh grid of ``cfg``."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator

    est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)
    return cli.Run(cfg=cfg, field=field, estimator=est, occ_state=est.init(dev),
                   opt=torch.optim.Adam(field.parameters(), lr=cli.LR),
                   generator=torch.Generator(device=dev).manual_seed(seed))


# Card against CPU, one MLP step at full width (256 rays): the loss within
# rtol 1e-5, every gradient within 5e-3 of its largest entry.  A weight's
# gradient sums one product a kept sample, of either sign, and cuBLAS and
# the CPU's GEMM add them in other orders (no TF32), so the gradients
# differ by float32 rounding that grows with the count of samples and
# their cancellation: 1.016e-05, 2.535e-04, 2.070e-04 and 6.31e-04 of the
# largest entry in four runs of the vanilla step, 4.01e-04 for T-NeRF (my
# chip runs, PR 12; phase 8 holds the NGP MLPs at 3e-4 for the same
# reason).  The CPU tests' 1e-5 holds 64-ray steps against JAX.  The step
# starts from the run's initial weights on its trained grid.  NDR's warp
# also rounds a position an ulp away now and then, which the degree-10
# encoding multiplies by up to 2^9 (tests/test_torch_mlp_train.py):
# 8.849e-03 measured on a warp bias, so 5e-2.
MLP_LOSS_RTOL, MLP_GRAD_TOL, NDR_GRAD_TOL = 1e-5, 5e-3, 5e-2


def mlp_card_vs_cpu(label, step_fn, make_field, run, batch, grad_tol=MLP_GRAD_TOL) -> None:
    """One ``step_fn(run, *batch)`` (an MLP CLI's ``train_step``) on the
    card and on the CPU from ``run``'s weights and grid, with the same rays,
    jitter and pixels (``batch``, CPU tensors): :func:`step_card_vs_cpu`.
    The MLP CLIs' Adam has eps 1e-8, and the gradients are held only to
    grad_tol of their largest entry: a parameter is held where |g| is above
    1e-6 and ten gradient tolerances (held where |g| > 1e-9, one of
    mlp.base.layers.3 was 2.075e-06 apart, and held where |g| > 1e-6, one
    of NDR's 2.636e-06, measured on an H100)."""
    weights = {k: v.detach().cpu().clone() for k, v in run.field.state_dict().items()}

    def make_run(device):
        field = make_field(device)
        field.load_state_dict(weights)
        return type(run)(cfg=run.cfg, field=field, estimator=run.estimator, occ_state=state_on(run.occ_state, device),
                         opt=torch.optim.Adam(field.parameters(), lr=run.opt.defaults["lr"]), generator=run.generator)

    step_card_vs_cpu(run.occ_state.occs.device, label, step_fn, make_run, batch, MLP_LOSS_RTOL, grad_tol,
                     run.opt.defaults["eps"], f"{batch[0].shape[0]} rays, full width")


def train_mlp(dev, card_line: str) -> dict:
    """Phase 13: the vanilla NeRF trained through ``train_mlp_nerf``'s own
    ``train`` (its ``train_step`` and ``occ_update``) at the CLI's
    NeRF-Synthetic configuration (``MLP_*``) on the textured procedural
    scene, with an eval of the test view every ``MLP_EVAL_EVERY`` steps;
    K1 as often a step as the traversal queries it and K3 once an update,
    each held against its plain version on the phase's own inputs; a
    profile of three late steps; one 800x800 eval view; one step at 256
    rays on the card against the CPU.  Returns the launches and K1's and
    K3's numbers."""
    from nerfacc_tpu_torch.datasets.procedural import make_loaders
    from nerfacc_tpu_torch.examples import train_mlp_nerf as cli
    from nerfacc_tpu_torch.examples.common import eval_metrics, psnr, render_image_chunked
    from nerfacc_tpu_torch.models.mlp import VanillaNeRFRadianceField

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_ds, test_ds = make_loaders(num_rays=MLP_RAYS, width=QUALITY_SIZE, height=QUALITY_SIZE,
                                     n_train=MLP_TRAIN_VIEWS, n_test=1, detail=1.0, device=dev)
    print(f"mlp data: {MLP_TRAIN_VIEWS + 1} views of {QUALITY_SIZE}x{QUALITY_SIZE} generated on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    cfg = dict(cli.build_config(procedural=False, smoke=False), samples_per_ray=64,
               sample_capacity=MLP_RAYS * 64)

    def new_run(seed):
        field = VanillaNeRFRadianceField(device=dev, generator=torch.Generator().manual_seed(seed))
        return mlp_run(cli, cfg, field, dev, seed)

    # Warm-up on a throwaway run (cuBLAS handles, the allocator).
    cli.train(new_run(1), train_ds, 2)
    run = new_run(0)
    n_params = sum(p.numel() for p in run.field.parameters())
    _, use_skip, *_ = run.estimator.plan_traversal(cfg["render_step_size"], 0.0, cfg["near_plane"])
    k1_per_step = 1 + int(use_skip)  # the lattice queries, and the skip probes
    test = test_ds[0]

    def evaluate():
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = render_image_chunked(lambda o, d: cli.eval_render(run, o, d), test["rays"], chunk=MLP_EVAL_CHUNK)
        torch.cuda.synchronize()
        return img, psnr(img, test["pixels"]), time.perf_counter() - t

    torch.cuda.reset_peak_memory_stats()
    r = train_segments("mlp", lambda until: cli.train(run, train_ds, until), run, MLP_MAX_STEPS, MLP_BUDGET_S,
                       MLP_EVAL_EVERY, counted_kernels(), lambda: {"psnr": evaluate()[1]})
    n_timed, train_s, launches = run.step, r["train_s"], r["launches"]
    late_ms, update_ms = r["late_ms"], r["update_ms"]
    peak = torch.cuda.max_memory_allocated()
    total = int(torch.stack(r["n_samps"]).sum())
    n_updates = (n_timed + cli.OCC_EVERY - 1) // cli.OCC_EVERY
    check_launches("mlp", launches, n_timed, k1_per_step, n_updates)
    # A step's loss follows its batch: the field learns when the last 16
    # steps' mean loss is below the first 16 steps'.
    first, last = falling("mlp", r["losses"])

    stages = ("fetch", "traverse_and_compact", "field_forward", "rendering", "backward", "optimizer", "occ_update")
    prof = profile_window(lambda: cli.train(run, train_ds, run.step + 3), stages,
                          f"mlp (3 steps from step {run.step})", "profile_train_mlp.txt")
    gather_ms = sum(ms for name, (ms, _) in prof["kernels"].items() if "indexing_backward" in name)
    gemm_ms = sum(ms for name, (ms, _) in prof["kernels"].items() if "gemm" in name)
    print(f"mlp profile: the scan's segment-start gather backward (scan.py:_seg_sums, indexing_backward_kernel) "
          f"{gather_ms:.3f} ms of {prof['busy_ms']:.3f} ms device time over 3 steps "
          f"({100 * gather_ms / prof['busy_ms']:.1f}%); the field's GEMMs (cuBLAS, float32) {gemm_ms:.3f} ms "
          f"({100 * gemm_ms / prof['busy_ms']:.1f}%)", flush=True)
    k1 = k1_on_train_inputs(lambda: cli.train(run, train_ds, run.step + 1), run.occ_state)

    def update():
        cli.occ_update(run, warmup=False)

    k3 = k3_on_update_inputs(update, dev)
    img, _, eval_s = evaluate()
    if not bool(torch.isfinite(img).all()) or not (0.0 <= float(img.min()) and float(img.max()) <= 1.0):
        fail("mlp: the eval image is not finite or outside [0, 1]")
    m = eval_metrics(img, test["pixels"])
    spr = total / n_timed / MLP_RAYS
    print(json.dumps({"mlp": {
        "card": card_line, "params": n_params, "steps": n_timed, "train_s": train_s,
        "late_step_ms": late_ms, "update_ms": update_ms, "samples_per_s": total / train_s,
        "rays_per_s": n_timed * MLP_RAYS / train_s, "samples_per_ray": spr,
        "occupied": float(run.occ_state.binaries.float().mean()), "peak_bytes": peak,
        "loss_first": first, "loss_last": last, "eval_rays_per_s": QUALITY_SIZE ** 2 / eval_s, "final": m,
        "psnr_curve": r["curve"], "k1_per_step": k1_per_step, "launches": {"K1": launches["K1"], "K3": launches["K3"]},
        "gather_backward_ms_3_steps": gather_ms, "gemm_ms_3_steps": gemm_ms, "device_ms_3_steps": prof["busy_ms"],
    }}), flush=True)
    print(f"mlp: {n_timed} steps in {train_s:.3f} s, late step {late_ms:.2f} ms, update {update_ms:.2f} ms, "
          f"{total / train_s:.1f} kept samples/s, {n_timed * MLP_RAYS / train_s:.1f} rays/s, {spr:.2f} samples a ray, "
          f"loss first {first:.6f} last {last:.6f}, eval view {QUALITY_SIZE ** 2 / eval_s:.1f} rays/s PSNR "
          f"{m['psnr']:.4f} SSIM {m['ssim']:.4f}; K1 {launches['K1']} ({k1_per_step} a step), K3 {launches['K3']} "
          f"({n_updates} updates); max_memory_allocated {peak} B", flush=True)
    if m["psnr"] < MLP_GATE_DB:
        fail(f"mlp: final PSNR {m['psnr']:.3f} dB is under {MLP_GATE_DB} dB")

    # One step at 256 rays, card against CPU (see MLP_GRAD_TOL).
    batch = train_ds[run.step]
    sel = slice(0, MLP_CPU_RAYS)
    jitter = torch.from_numpy(np.random.default_rng(13).random(MLP_CPU_RAYS, dtype=np.float32))
    args = (batch["rays"].origins[sel], batch["rays"].viewdirs[sel], batch["pixels"][sel], batch["color_bkgd"])
    probe = new_run(0)  # the initial weights, on the trained grid
    probe.occ_state = run.occ_state
    mlp_card_vs_cpu("vanilla NeRF", cli.train_step, lambda device: VanillaNeRFRadianceField(device=device), probe,
                    tuple(t.cpu() for t in args) + (jitter,))
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=k1, k3=k3)


# The dynamic fields' phases and their card-against-CPU steps: (label, the
# CLI's field, its seed, the gradient gate).
DYNAMIC_PHASES = {
    "tnerf": (14, (("T-NeRF", "tnerf", 0, MLP_GRAD_TOL), ("NDR", "ndr", 2, NDR_GRAD_TOL))),
    "tineuvox": (17, (("TiNeuVox", "tineuvox", 0, MLP_GRAD_TOL),)),
}


def train_dynamic(dev, card_line, name) -> dict:
    """Phase 14 (``name`` "tnerf") and phase 17 ("tineuvox", resolution 96):
    ``train_mlp_tnerf --field name`` (``TNERF_*``) trained through its own
    ``train`` for ``TNERF_STEPS`` steps on the dynamic procedural scene, K1
    as often a step as the traversal queries it and K3 once an update,
    counted; 15 late steps on the clock; the ``DYNAMIC_PHASES[name]`` steps
    at 256 rays from the initial weights on the trained grid, card against
    CPU; then a profile of three late steps, and K1 and K3 held against
    their plain versions on the phase's own inputs.  Returns the launches
    and K1's and K3's numbers."""
    from nerfacc_tpu_torch.datasets.procedural import make_dynamic_loaders
    from nerfacc_tpu_torch.examples import train_mlp_nerf as mlp_cli
    from nerfacc_tpu_torch.examples import train_mlp_tnerf as cli

    t_phase = time.perf_counter()
    phase, held = DYNAMIC_PHASES[name]
    train_ds, _ = make_dynamic_loaders(num_rays=MLP_RAYS, width=TNERF_SIZE, height=TNERF_SIZE,
                                       n_train=TNERF_TRAIN_VIEWS, n_test=1, device=dev)
    cfg = dict(mlp_cli.build_config(procedural=False, smoke=False), sample_capacity=MLP_RAYS * cli.SAMPLES_PER_RAY)

    def field(device, seed=0, kind=name):
        return cli.make_field(kind, cfg, smoke=False, device=device, generator=torch.Generator().manual_seed(seed))

    cli.train(mlp_run(mlp_cli, cfg, field(dev, 1), dev, 1), train_ds, 2)  # warm-up
    run = mlp_run(mlp_cli, cfg, field(dev), dev)
    _, use_skip, *_ = run.estimator.plan_traversal(cfg["render_step_size"], 0.0, cfg["near_plane"])
    k1_per_step = 1 + int(use_skip)
    counted = counted_kernels()
    before = {k: w.launches for k, w in counted.items()}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, n_samp = cli.train(run, train_ds, TNERF_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k: w.launches - before[k] for k, w in counted.items()}
    n_updates = (TNERF_STEPS + mlp_cli.OCC_EVERY - 1) // mlp_cli.OCC_EVERY
    check_launches(name, launches, TNERF_STEPS, k1_per_step, n_updates)
    first, last = falling(name, losses)
    # Then 15 steps between two updates on the clock.
    cli.train(run, train_ds, (run.step // mlp_cli.OCC_EVERY + 1) * mlp_cli.OCC_EVERY + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.train(run, train_ds, run.step + 15)
    torch.cuda.synchronize()
    late_ms = (time.perf_counter() - t0) / 15 * 1e3
    # The card-against-CPU steps on this grid and batch, before the checks
    # below step the run on.
    batch = train_ds[run.step]
    sel = slice(0, MLP_CPU_RAYS)
    jitter = torch.from_numpy(np.random.default_rng(phase).random(MLP_CPU_RAYS, dtype=np.float32))
    args = tuple(t.cpu() for t in (batch["rays"].origins[sel], batch["rays"].viewdirs[sel], batch["timestamps"][sel],
                                   batch["pixels"][sel], batch["color_bkgd"])) + (jitter,)
    for label, kind, seed, tol in held:
        probe = mlp_run(mlp_cli, cfg, field(dev, seed, kind), dev)
        probe.occ_state = run.occ_state  # the initial weights, on the trained grid
        mlp_card_vs_cpu(label, cli.train_step, lambda device, kind=kind: field(device, 0, kind), probe, args,
                        grad_tol=tol)
    total = int(torch.stack(n_samp).sum())
    stages = ("traverse_and_compact", "field_forward", "rendering", "backward", "optimizer", "occ_update",
              "voxel_gather_backward")
    prof = profile_window(lambda: cli.train(run, train_ds, run.step + 3), stages,
                          f"{name} (3 steps from step {run.step})", f"profile_train_{name}.txt")
    shares = gather_shares(name, prof)
    k1 = k1_on_a_late_step(lambda: cli.train(run, train_ds, run.step + 1), run)
    train_times = torch.from_numpy(train_ds.timestamps).to(dev)
    k3 = k3_on_update_inputs(lambda: cli.occ_update(run, False, train_times), dev)
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({name: {
        "card": card_line, "steps": TNERF_STEPS, "train_s": dt, "late_step_ms": late_ms,
        "rays_per_s": TNERF_STEPS * MLP_RAYS / dt, "samples_per_s": total / dt,
        "samples_per_ray": total / TNERF_STEPS / MLP_RAYS, "peak_bytes": peak, "loss_first": first,
        "loss_last": last, "k1_per_step": k1_per_step, "launches": {"K1": launches["K1"], "K3": launches["K3"]},
        "profile": shares,
    }}), flush=True)
    print(f"{name}: {TNERF_STEPS} steps in {dt:.3f} s ({dt / TNERF_STEPS * 1e3:.2f} ms a step with its updates), "
          f"late step {late_ms:.2f} ms, {TNERF_STEPS * MLP_RAYS / dt:.1f} rays/s, {total / dt:.1f} kept samples/s, "
          f"loss first {first:.6f} last {last:.6f}; K1 {launches['K1']} ({k1_per_step} a step), K3 {launches['K3']} "
          f"({n_updates} updates)", flush=True)
    print(f"phase {phase} took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=k1, k3=k3)


def k1_render_inputs(dev, rng) -> tuple:
    """K1 at the render shape: the estimator and its state on the shell,
    the level-0 box, and 4096 rays x a 256-step window of query positions,
    as traverse_grids computes them."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.grid import _march_ladder

    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1)
    state = est.set_binaries(est.init(dev), torch.from_numpy(shell_binaries(GRID_RES)))
    n_q_rays, window = CHUNK, 256
    d = rng.normal(size=(n_q_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o = torch.from_numpy(-3.0 * d).to(dev)
    rays_d = torch.from_numpy(d).to(dev)
    near = torch.full((n_q_rays,), 1.8, device=dev)
    edges = _march_ladder(near, window + 1, STEP, 0.0)
    t_mid = (edges[:, :-1] + edges[:, 1:]) * 0.5
    pxyz = [(rays_o[:, i : i + 1] + t_mid * rays_d[:, i : i + 1]).contiguous() for i in range(3)]
    return est, state, state.aabbs[0].contiguous(), pxyz


def k1_bytes_ops(n_q: int, packed) -> tuple:
    """K1's bytes (three float32 coordinates read and one byte written a
    query, the packed grid read once) and float operations (~30 a query:
    normalise, mip, three cells)."""
    return n_q * (3 * 4 + 1) + packed.numel() * 4 + 6 * 4, n_q * 30


def k1_vs_plain(dev):
    """Phase 2: K1 against its plain version on the render shape and on
    adversarial points, and its times.  Returns the estimator and its state
    (for phase 3) and K1's numbers for the kernel table."""
    from nerfacc_tpu_torch.ops.occ_query import (
        _query_soa,
        bitpack_grid,
        occupancy_query,
        occupancy_query_plain,
    )

    rng = np.random.default_rng(0)
    est, state, base, pxyz = k1_render_inputs(dev, rng)
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
    k1_bytes, k1_ops = k1_bytes_ops(n_q, packed)
    k1_bound_bytes_ms = k1_bytes / HBM_BYTES_PER_S * 1e3
    k1_bound_ops_ms = k1_ops / F32_OPS_PER_S * 1e3
    k1_bound_ms = max(k1_bound_bytes_ms, k1_bound_ops_ms)
    print(
        f"K1 at {n_q} queries: kernel {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, "
        f"bound {k1_bound_ms:.4f} ms ({k1_bytes} B at 3.35 TB/s)",
        flush=True,
    )
    return est, state, dict(err=k1_max_err, ms=k1_ms, plain_ms=k1_plain_ms, bytes=k1_bytes, ops=k1_ops)


def serve(dev, est, state, crop: bool) -> float:
    """Phase 3: one 800x800 view at full width through the port, K1 launched
    on that path, a profile of every 8th chunk, and the view's central 64x64
    rays (4096) rendered with ``lattice_per_round=64`` on the card against
    the CPU; then, if ``crop``, phase 4: the same crop at the default window
    on the card against the CPU.  Returns the view's rays/s."""
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField
    from nerfacc_tpu_torch.ops.occ_query import occupancy_query
    from nerfacc_tpu_torch.rendering import occgrid_render_rays_test

    gen = torch.Generator().manual_seed(0)
    field = NGPRadianceField(aabb=AABB, device=dev, generator=gen, **FIELD_CFG)
    field.eval()
    builder = field_builder(field)
    o_all, d_all = view_rays(dev)
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
        ("traverse_grids", "compact_indices_from_counts", "gather_combine",
         "render_weight_from_density", "accumulate_along_rays"),
        "serve", "profile_serve.txt",
    )

    # The central 64x64 rays of the view, on the card and on the CPU.
    r0 = (HEIGHT - CROP) // 2
    c0 = (WIDTH - CROP) // 2
    crop_o = o_all.view(HEIGHT, WIDTH, 3)[r0 : r0 + CROP, c0 : c0 + CROP].reshape(-1, 3)
    crop_d = d_all.view(HEIGHT, WIDTH, 3)[r0 : r0 + CROP, c0 : c0 + CROP].reshape(-1, 3)
    cpu = torch.device("cpu")
    field_cpu = NGPRadianceField(aabb=AABB, device=cpu, **FIELD_CFG)
    field_cpu.load_state_dict({k: v.cpu() for k, v in field.state_dict().items()})
    state_cpu = est.set_binaries(est.init(cpu), state.binaries.cpu())

    def crop_card_vs_cpu(label, **kw):
        occupancy_query.launches = 0
        rgb_gpu, opa_gpu, dep_gpu, n_gpu = occgrid_render_rays_test(
            builder, est, state, crop_o, crop_d, render_bkgd=bkgd, **RENDER_KW, **kw
        )
        k1 = occupancy_query.launches
        t0 = time.perf_counter()
        rgb_cpu, opa_cpu, dep_cpu, n_cpu = occgrid_render_rays_test(
            field_builder(field_cpu), est, state_cpu,
            crop_o.cpu(), crop_d.cpu(), render_bkgd=bkgd.cpu(), **RENDER_KW, **kw,
        )
        print(f"CPU {label} rendered in {time.perf_counter() - t0:.1f} s", flush=True)
        # atol 1e-4: the card sums in another order (atomic index_add_, GEMM
        # tiling), and those last-bit differences add up over ~1000 samples/ray.
        errs = {
            name: float((a.cpu() - b).abs().max())
            for name, a, b in (("rgb", rgb_gpu, rgb_cpu), ("opacity", opa_gpu, opa_cpu),
                               ("depth", dep_gpu, dep_cpu))
        }
        print(f"card vs CPU {label}: max abs err {errs}, samples {n_gpu} vs {n_cpu}, K1 launches {k1}", flush=True)
        if n_gpu != n_cpu:
            fail(f"card and CPU rendered different sample counts ({label}: {n_gpu} vs {n_cpu})")
        if max(errs.values()) > 1e-4:
            fail(f"card and CPU disagree beyond atol 1e-4 ({label}): {errs}")
        if n_gpu <= 0 or k1 <= 0:
            fail(f"{label}: no samples rendered or K1 never launched")

    # A window of 64 lattice steps a round, against the default
    # min(full lattice, 8 x 32) (rendering.py:321).
    crop_card_vs_cpu("crop, lattice_per_round=64", lattice_per_round=64)
    if crop:  # Phase 4: card against CPU on the 64x64 crop.
        crop_card_vs_cpu("crop")
    return n_rays / dt


# Phase 15: the other encoders and the structure-of-arrays route.  (a) is
# bench.py's step with BENCH_ENCODER=hash BENCH_LEVELS=16 BENCH_FEATS=2
# BENCH_LOG2T=19 (tcnn's parametrisation, bench.py:896-900's reference arm;
# the MLPs in bf16, the encoder in float32, as the JAX package gives hash no
# compute_dtype); (b) phase 6's step with BENCH_SOA=1 and BENCH_OCC_SOA=1;
# (c) BENCH_ENCODER=folded at bench.py's defaults (L4 x F16, 2^18), soa at
# the tcnn shape and the fused encoder's scatter route, each one step on the
# card against the CPU, and chunk-paired levels on the factor (K2) and
# pallas (K5) routes; (d) traverse_grids' macro-skip branch on phase 3's grid.
HASH_FIELD_CFG = dict(
    encoder_type="hash", n_levels=16, n_features_per_level=2, log2_hashmap_size=19,
    mlp_width=64, geo_feat_dim=15,
)
SOA_FIELD_CFG = dict(HASH_FIELD_CFG, encoder_type="soa")
FOLDED_FIELD_CFG = dict(TRAIN_FIELD_CFG, encoder_type="folded")


def timed_steps(step, iters=TRAIN_ITERS) -> tuple:
    """3 warm-up calls of ``step()`` (which returns ``(loss, n_samples)``),
    then ``iters`` timed on the host clock without a host read: the ms a
    step and the kept samples over the window."""
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = [step()[1] for _ in range(iters)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3, int(torch.stack(n).sum())


def soa_route(dev, phase6_step_ms) -> dict:
    """Phase 15b: phase 6's fused bf16 step on the SoA route (ray components
    added by the traversal, the field on ``(xs, ys, zs)``, the update's
    probes as tuples) held against the array route on the card: the same
    compaction, the loss and the table gradient within 1e-6 of its largest
    entry, the updated occupancy bit-equal given the same draws, and K2 and
    K3 as often a step and an update; then 30 timed steps of each route,
    8 timed SoA updates, and K2 and K3 on the SoA route's own inputs."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    bf = torch.bfloat16
    est, state, base, _, (rays_o, rays_d), pixels = bench_setup(dev, TRAIN_FIELD_CFG, bf)
    weights = {k: v.detach().clone() for k, v in base.state_dict().items()}
    jitter = torch.rand((TRAIN_RAYS,), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    draws = est.make_draws(10**9, torch.Generator().manual_seed(3), device=dev)

    res = {}
    for soa in (False, True):
        cs = est.compact_samples(state, rays_o, rays_d, render_step_size=STEP, stratified=True, jitter=jitter,
                                 sample_capacity=TRAIN_CAPACITY, max_macro_segments=TRAIN_MACRO, carry_rays=soa)
        field = bench_setup(dev, TRAIN_FIELD_CFG, bf, weights)[2]
        opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
        tg.table_grad_u10.launches = tg.cell_max.launches = 0
        loss, n_samp, _ = train_step(field, opt, est, state, rays_o, rays_d, pixels, jitter, TRAIN_CAPACITY, soa=soa)
        k2 = tg.table_grad_u10.launches
        grad = field.encoder.table.grad.detach().clone()
        new = occ_update(est, state, field, draws=draws, soa_positions=soa)
        torch.cuda.synchronize()
        res[soa] = dict(cs=cs, loss=float(loss), n=int(n_samp), grad=grad, occs=new.occs, binaries=new.binaries,
                        k2=k2, k3=tg.cell_max.launches)
    a, b = res[True], res[False]
    for name in ("ray_indices", "t_starts", "t_ends", "kept"):
        if not torch.equal(getattr(a["cs"], name), getattr(b["cs"], name)):
            fail(f"SoA route: the compaction's {name} differs from the array route's")
    comps = a["cs"].ray_comps
    ri = a["cs"].ray_indices.long()
    for part, rays in ((0, rays_o), (1, rays_d)):
        for k in range(3):
            if not torch.equal(comps[part][k], rays[ri, k]):
                fail("SoA route: a carried ray component is not its ray's")
    scale = float(b["grad"].abs().max())
    g_err = float((a["grad"] - b["grad"]).abs().max())
    loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    print(f"SoA route against the array route on the card: kept {a['n']} = {b['n']}, compaction equal, "
          f"loss {a['loss']:.7f} vs {b['loss']:.7f} (rel err {loss_err:.2e}), table gradient max abs err "
          f"{g_err:.3e} (largest {scale:.3e}), occupancy after an update equal: "
          f"{torch.equal(a['occs'], b['occs'])}, binaries equal: {torch.equal(a['binaries'], b['binaries'])}; "
          f"K2 {a['k2']} vs {b['k2']} a step, K3 {a['k3']} vs {b['k3']} an update", flush=True)
    if a["n"] != b["n"] or loss_err > 1e-6 or g_err > 1e-6 * scale:
        fail("SoA route: the step differs from the array route's")
    if not (torch.equal(a["occs"], b["occs"]) and torch.equal(a["binaries"], b["binaries"])):
        fail("SoA route: the update with tuple probes differs from the array update")
    if (a["k2"], a["k3"]) != (b["k2"], b["k3"]) or a["k2"] != 1 or a["k3"] != 1:
        fail(f"SoA route: K2/K3 launches {a['k2']}/{a['k3']}, array route {b['k2']}/{b['k3']}, expected 1/1")

    # 30 timed steps of each route, then 8 timed SoA updates (the counts
    # are read just after).
    ms = {}
    for soa in (False, True):
        _, state_, field, opt, _, _ = bench_setup(dev, TRAIN_FIELD_CFG, bf, weights)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step():
            u = torch.rand((TRAIN_RAYS,), generator=gen, device=dev)
            return train_step(field, opt, est, state_, rays_o, rays_d, pixels, u, TRAIN_CAPACITY, soa=soa)[:2]

        tg.table_grad_u10.launches = tg.cell_max.launches = 0
        ms[soa], total = timed_steps(step)
        k2_launches = tg.table_grad_u10.launches
        if soa:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_UPDATES):
                occ_update(est, state_, field, generator=gen, soa_positions=True)
            torch.cuda.synchronize()
            update_ms = (time.perf_counter() - t0) / TRAIN_UPDATES * 1e3
            k3_launches = tg.cell_max.launches
            soa_step, soa_field, soa_state = step, field, state_
    sps = total / ((ms[True] * TRAIN_ITERS + TRAIN_ITERS / 16.0 * update_ms) / 1e3)
    print(f"train (fused, bf16, SoA route): {sps:.1f} samples/s, step {ms[True]:.2f} ms (array route "
          f"{ms[False]:.2f} ms in this phase" + (f", phase 6 {phase6_step_ms:.2f} ms" if phase6_step_ms else "")
          + f"), SoA update {update_ms:.2f} ms; launches K2 {k2_launches} in {TRAIN_ITERS + 3} steps, "
          f"K3 {k3_launches} in {TRAIN_UPDATES} updates", flush=True)
    if k2_launches != TRAIN_ITERS + 3 or k3_launches != TRAIN_UPDATES:
        fail("SoA route: K2 must launch once a step and K3 once an update")
    k2 = grad_kernel_on_step_inputs("K2", "table_grad_u10", soa_step, "one SoA-route step")
    k3 = k3_on_update_inputs(lambda: occ_update(est, soa_state, soa_field, soa_positions=True), dev)
    return dict(k2=k2, k3=k3, launches={"K2": k2_launches, "K3": k3_launches}, step_ms=ms[True])


# Weight seeds of phase 15c's float32 routes: each route's step is held at
# each, so that one run shows how often a ReLU input takes another sign on
# the card and what that moves.
F32_SEEDS = (0, 1, 2, 3)


def flip_reach(field, enc_in, ray_indices, flipped, n_rays) -> dict:
    """The gradient entries that the samples ``flipped`` (a ReLU input of
    another sign on the card than on the CPU) feed: the table entries that
    their encoding gathers, found as the nonzero entries of the table
    gradient of their summed encoding (the corner weights are nonnegative),
    and the ray origins of their rays."""
    x = enc_in.detach()[flipped]
    table = field.encoder.table
    reach = {"encoder.table": torch.autograd.grad(field.encoder(x).float().sum(), table)[0] != 0}
    rays = torch.zeros((n_rays, 3), dtype=torch.bool)
    rays[ray_indices[flipped].long()] = True
    reach["rays_o"] = rays
    return reach


def encoder_steps_card_vs_cpu(dev) -> None:
    """Phase 15c: one step at 1024 rays and 2^15 samples on the card and on
    the CPU, from the same weights, jitter and draws: the folded encoder
    (bench.py's defaults), soa (the tcnn shape) and the fused scatter route
    (with the gradient of the ray origins, the positions' only route), all
    float32 and each from the weight seeds ``F32_SEEDS``, loss within rtol
    1e-5 and every gradient within 3e-4 of its largest entry, but 3e-3 for
    the table entries and ray origins fed by a sample whose ReLU input took
    another sign on the card than on the CPU (:func:`flip_reach`); and
    chunk-paired levels (``paired_safe_levels``) on the fused bf16 factor
    (K2, once a lookup) and pallas (K5, once a level) routes, and the
    grouped encoder in bf16 with ``table_grad="factor"`` (K6) and
    ``"scatter"`` (no kernel, with the gradient of the ray origins), loss
    within rtol 1e-5 and gradients within 2e-2 (phase 8's bf16 gate).  Each
    route launches exactly its kernels."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.ops import table_grad as tg

    cpu, bf = torch.device("cpu"), torch.bfloat16
    n_rays, capacity = 1024, 1 << 15
    rng = np.random.default_rng(2)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = torch.from_numpy(-3.0 * d), torch.from_numpy(d)
    pixels = torch.from_numpy(rng.random((n_rays, 3), dtype=np.float32))
    jitter = torch.from_numpy(rng.random(n_rays, dtype=np.float32))
    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1, skip_factor=2)
    shell = torch.from_numpy(shell_binaries(GRID_RES))
    paired = ngp_field(TRAIN_FIELD_CFG, None, cpu).paired_safe_levels(STEP)
    wrappers = ("table_grad_u10", "table_grad_w3", "table_grad_w8", "table_grad_sorted", "table_grad_pos")
    routes = (
        # (label, field configuration, compute dtype, gradient tolerance,
        #  paired levels, the kernels' launches, the origins' gradient,
        #  weight seeds)
        ("folded float32", FOLDED_FIELD_CFG, None, 3e-4, 0, {}, False, F32_SEEDS),
        ("soa float32", SOA_FIELD_CFG, None, 3e-4, 0, {}, False, F32_SEEDS),
        ("fused scatter float32", dict(TRAIN_FIELD_CFG, table_grad="scatter"), None, 3e-4, 0, {}, True, F32_SEEDS),
        (f"fused factor bf16, {paired} paired", TRAIN_FIELD_CFG, bf, 2e-2, paired, {"table_grad_u10": 2}, False,
         (0,)),
        (f"fused pallas bf16, {paired} paired", dict(TRAIN_FIELD_CFG, table_grad="pallas"), bf, 2e-2, paired,
         {"table_grad_sorted": TRAIN_FIELD_CFG["n_levels"]}, False, (0,)),
        ("grouped factor bf16", GROUPED_FIELD_CFG, bf, 2e-2, 0, {"table_grad_pos": 1}, False, (0,)),
        ("grouped scatter bf16", dict(GROUPED_FIELD_CFG, table_grad="scatter"), bf, 2e-2, 0, {}, True, (0,)),
    )
    results = []
    for route_label, cfg, cdt, tol, pl, kernels, pos, seeds in routes:
        for seed in seeds:
            label = f"{route_label}, seed {seed}"
            seeded = dict(cfg, generator=torch.Generator().manual_seed(seed))
            weights = {k: v.detach().clone() for k, v in ngp_field(seeded, cdt, cpu).state_dict().items()}
            res = []
            for device in (dev, cpu):
                field = ngp_field(cfg, cdt, device)
                field.load_state_dict({k: v.to(device) for k, v in weights.items()})
                opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
                state = est.set_binaries(est.init(device), shell)
                ro = rays_o.to(device).clone().requires_grad_(pos)
                for w in wrappers:
                    getattr(tg, w).launches = 0
                # The sign of every ReLU's input: the card's and the CPU's
                # GEMMs round differently, and a pre-activation within an ulp
                # of 0 may fall on the other side, which moves that sample's
                # gradient.  And the encoder's input, to find what such a
                # sample feeds.
                signs, enc_in = [], []
                hooks = [m.register_forward_hook(lambda mod, inp, out: signs.append((inp[0] > 0).cpu()))
                         for m in field.modules() if isinstance(m, torch.nn.ReLU)]
                hooks.append(field.encoder.register_forward_hook(lambda mod, inp, out: enc_in.append(inp[0])))
                t0 = time.perf_counter()
                loss, n_samp, extras = train_step(field, opt, est, state, ro, rays_d.to(device),
                                                  pixels.to(device), jitter.to(device), capacity, paired_levels=pl)
                for h in hooks:
                    h.remove()
                grads = {k: p.grad.detach().cpu() for k, p in field.named_parameters()}
                if pos:
                    grads["rays_o"] = ro.grad.detach().cpu()
                used = None
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    used = {w: getattr(tg, w).launches for w in wrappers}
                res.append(dict(loss=float(loss), n=int(n_samp), grads=grads, used=used, signs=signs,
                                params={k: p.detach().cpu() for k, p in field.named_parameters()},
                                kept=extras["kept"].cpu(), ray_indices=extras["ray_indices"].cpu(),
                                field=field, enc_in=enc_in, s=time.perf_counter() - t0))
            a, b = res
            if any(sa.shape[0] != capacity for sa in a["signs"]) or len(b["enc_in"]) != 1:
                fail(f"card vs CPU ({label}): the ReLU inputs are not one row a sample")
            flipped = torch.zeros(capacity, dtype=torch.bool)
            for sa, sb in zip(a["signs"], b["signs"]):
                flipped |= (sa != sb).any(dim=-1)
            flips = sum(int((sa != sb).sum()) for sa, sb in zip(a["signs"], b["signs"]))
            # A float32 route holds every entry at 3e-4 except those that a
            # flipped sample feeds: that sample's terms move whole there, and
            # a fine hashed row fed by it alone can move by its own size.
            wide = None
            if cdt is None and bool(flipped.any()):
                wide = flip_reach(b["field"], b["enc_in"][0], b["ray_indices"], flipped, n_rays)
            # Every gradient's error first (and outside the flipped samples'
            # entries), so that one run shows where a route departs.
            errs, inner = {}, {}
            for k, g in b["grads"].items():
                err = (a["grads"][k] - g).abs() / max(float(g.abs().max()), 1e-30)
                errs[k] = float(err.max())
                if wide is not None and k in wide:
                    inner[k] = float(torch.where(wide[k], 0.0, err).max())
            reached = int(wide["encoder.table"].sum()) if wide is not None else 0
            print(f"card vs CPU ({label}): kept equal {torch.equal(a['kept'], b['kept'])}, {flips} ReLU inputs "
                  f"of another sign in {int(flipped.sum())} samples, feeding {reached} table entries; loss rel "
                  f"err {abs(a['loss'] - b['loss']) / abs(b['loss']):.2e}, gradient rel errs "
                  + ", ".join(f"{k} {v:.2e}" + (f" ({inner[k]:.2e} elsewhere)" if k in inner else "")
                              for k, v in errs.items()), flush=True)
            results.append((label, tol, kernels, pos, a, b, wide))
    for label, tol, kernels, pos, a, b, wide in results:
        if a["used"] != {w: kernels.get(w, 0) for w in wrappers}:
            fail(f"card vs CPU ({label}): table-gradient launches {a['used']}, expected {kernels}")
        if pos:  # the origins have no Adam step to hold
            g_a, g_b = a["grads"].pop("rays_o"), b["grads"].pop("rays_o")
            pos_tol = tol if wide is None else torch.where(wide["rays_o"], WIDE_TOL, tol)
            pos_err = float(((g_a - g_b).abs() / (pos_tol * float(g_b.abs().max()))).max())
            if not pos_err <= 1.0 or not bool(g_b.abs().max() > 0):
                fail(f"card vs CPU ({label}): the positions' gradient differs: {pos_err} of its tolerance")
        hold_step(label, a, b, tol, tol, f"{n_rays} rays, capacity {capacity}", wide=wide)
        loss_err = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        if loss_err > 1e-5:
            fail(f"card vs CPU ({label}): loss rel err {loss_err} > 1e-5")


def skip_traversal_on_card(dev) -> int:
    """Phase 15d: traverse_grids with the macro-skip branch on phase 3's
    grid (the res-128 shell, skip factor 4) for 4096 rays on the card:
    the same ``num_valid``, validity and intervals (within 1e-5) as the
    dense branch; K1's skip probes held exact against its plain version and
    counted.  Returns the skip probes' launches."""
    import nerfacc_tpu_torch.grid as grid_mod
    from nerfacc_tpu_torch.ops.occ_query import occupancy_query, occupancy_query_plain

    rng = np.random.default_rng(0)
    est, state, base, _ = k1_render_inputs(dev, rng)
    d = rng.normal(size=(CHUNK, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays_o, rays_d = torch.from_numpy(-3.0 * d).to(dev), torch.from_numpy(d).to(dev)
    lattice, use_skip, stride, max_macro, row_cap = est.plan_traversal(STEP, max_macro_segments=24)
    if not use_skip:
        fail("skip traversal: the plan takes no macro-skip at phase 3's grid")
    kw = dict(step_size=STEP, traverse_steps_limit=row_cap, packed_grids=state.binaries_packed,
              max_lattice_steps=lattice, base_aabb=base)
    calls = []

    def recording(packed, aabb, px, py, pz, rz, mip_pad=0):
        calls.append((packed, aabb, (px, py, pz), rz, mip_pad))
        return occupancy_query(packed, aabb, px, py, pz, rz=rz, mip_pad=mip_pad)

    dense = grid_mod.traverse_grids(rays_o, rays_d, state.binaries, state.aabbs, **kw)
    occupancy_query.launches = 0
    grid_mod.occupancy_query = recording
    try:
        skip = grid_mod.traverse_grids(rays_o, rays_d, state.binaries, state.aabbs, skip_grid=state.skip_grid,
                                       packed_skip=state.skip_packed, macro_stride=stride,
                                       max_macro_segments=max_macro, **kw)
        torch.cuda.synchronize()
    finally:
        grid_mod.occupancy_query = occupancy_query
    launches = occupancy_query.launches
    probes = [c for c in calls if c[4] == 1]
    for packed, aabb, pts, rz, mip_pad in probes:
        if packed is not state.skip_packed:
            fail("skip traversal: a probe on a grid other than skip_packed")
        if not torch.equal(occupancy_query(packed, aabb, *pts, rz=rz, mip_pad=1),
                           occupancy_query_plain(packed, aabb, *pts, rz=rz, mip_pad=1)):
            fail("skip traversal: K1 disagrees with its plain version on the skip probes")
    t_err = max(float((torch.where(dense.is_valid, getattr(dense, k), 0.0)
                       - torch.where(skip.is_valid, getattr(skip, k), 0.0)).abs().max())
                for k in ("t_starts", "t_ends"))
    same = torch.equal(dense.num_valid, skip.num_valid) and torch.equal(dense.is_valid, skip.is_valid)
    print(f"traverse_grids with the skip grid on the card: {CHUNK} rays, lattice {lattice}, macro stride "
          f"{stride}, budget {max_macro}; samples {int(skip.num_valid.sum())} = {int(dense.num_valid.sum())} "
          f"dense, num_valid and validity equal: {same}, t max abs err {t_err:.3e}; K1 launches {launches} "
          f"({len(probes)} skip-probe launches of {tuple(probes[0][2][0].shape) if probes else ()}, exact)",
          flush=True)
    if not same or t_err > 1e-5 or len(probes) != 1 or launches != 2:
        fail("skip traversal: the macro-skip branch differs from the dense branch, or K1 was not launched "
             "for its probes")
    return len(probes)


def train_encoders(dev, phase6_step_ms=None) -> dict:
    """Phase 15 (see the module docstring): (a) the hash encoder at the
    reference's shape, (b) the SoA route, (c) card against CPU for the other
    encoders and routes and 30 timed folded steps, (d) the macro-skip
    traversal.  Returns K1's numbers on (a)'s lattice queries and K2's and
    K3's on (b)'s inputs, with their launches."""
    t_phase = time.perf_counter()
    details = {}
    _, launches, _, hash_ms = train_full_width(
        dev, HASH_FIELD_CFG, None, None, "profile_train_hash.txt", check_inputs=True, details=details,
    )
    prof = details["profile"]
    share = {
        label: sum(ms for name, (ms, _) in prof["kernels"].items() if any(k in name for k in keys))
        # PyTorch runs this index_select as a gather kernel; the traversal's
        # few small gathers count there too.
        for label, keys in (("index_add_ (table gradient)", ("indexFunc",)),
                            ("index_select and gather", ("indexSelect", "_scatter_gather_elementwise")))
    }
    print("hash encoder (phase 15a): " + ", ".join(
        f"{k} {v:.1f} ms = {100 * v / prof['busy_ms']:.1f}% of device time" for k, v in share.items())
        + f" over 3 steps and an update; step {hash_ms:.2f} ms, update {details['update_ms']:.2f} ms, "
        f"{details['sps']:.1f} samples/s", flush=True)
    soa = soa_route(dev, phase6_step_ms)
    encoder_steps_card_vs_cpu(dev)
    # 30 timed steps of bench.py's folded arm (bf16 MLPs, its default dtype).
    est, state, field, opt, (rays_o, rays_d), pixels = bench_setup(dev, FOLDED_FIELD_CFG, torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(0)
    folded_ms, total = timed_steps(lambda: train_step(
        field, opt, est, state, rays_o, rays_d, pixels, torch.rand((TRAIN_RAYS,), generator=gen, device=dev),
        TRAIN_CAPACITY)[:2])
    print(f"train (folded L4 x F16, 2^18, bf16 MLPs): step {folded_ms:.2f} ms, "
          f"{total / (folded_ms * TRAIN_ITERS / 1e3):.1f} kept samples/s over {TRAIN_ITERS} steps", flush=True)
    del est, state, field, opt
    skip_probes = skip_traversal_on_card(dev)
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=details["k1"], soa=soa, skip_probes=skip_probes)


# Phase 16: examples/train_ngp_nerf_occ.py --field tensorf|kplanes at its
# synthetic block (:45-58: aabb +-1.5, a res-128 grid, step 5e-3, 8192 rays
# and 2^18 slots, near 0, weight decay 1e-6; Adam at eps 1e-15 on the
# 20000-step schedule), each field at its defaults (TensoRF R 128 with 8 and
# 24 components; K-Planes R 128 with 32 features, view-independent as the
# example builds it), on the CLI's own procedural scene (no --data_root:
# 36 train and 2 test views of 160x160, :104-117); up to PLUGIN_BUDGET_S of
# train time each.  Phase 17: train_mlp_tnerf --field tineuvox (:85-91:
# resolution 96, width 64) at phase 14's block and scene, TNERF_STEPS steps.
# Phase 18: train_barf at its non-smoke widths (the 8 x 256 field, 24 views
# of 160x160, a 64^3 grid, 1024 rays x 64 slots, pose noise 0.10), its
# schedules over BARF_MAX_STEPS (the example's 6000 cut to about 50 s of
# train time on an H100; 3000 before phase 19 took its share of the run).
PLUGIN_FIELDS = ("tensorf", "kplanes")
PLUGIN_SIZE, PLUGIN_TRAIN_VIEWS, PLUGIN_TEST_VIEWS = 160, 36, 2
PLUGIN_MAX_STEPS, PLUGIN_BUDGET_S, PLUGIN_SEGMENT, PLUGIN_CPU_RAYS = 3000, 45.0, 250, 256
# Card against CPU, the float32 gate: every gradient within 3e-4 of its
# largest entry (phases 8 and 15c hold the NGP MLPs there), BARF's pose
# deltas too (phase 18: 3.34e-05 of the largest entry measured on an H100).
PLUGIN_GRAD_TOL = 3e-4
BARF_MAX_STEPS, BARF_BUDGET_S, BARF_SEGMENT = 2000, 100.0, 250
GATHER_STAGES = ("plane_gather_backward", "line_gather_backward", "voxel_gather_backward")


def train_segments(label, train, run, max_steps, budget_s, segment, counted, probe=None) -> dict:
    """``train(until)`` from ``run.step`` in segments of ``segment`` steps
    while ``max_steps`` and ``budget_s`` seconds of train time allow one
    more segment as long as the last: in each, the steps up to 16k, then 15
    steps alone on the clock (a late step's ms), then one with its
    occupancy update (the update's ms over a late step), then the rest.
    Returns the losses and kept-sample counts (device
    tensors), the train seconds, the late step's and the update's ms, the
    launches of each wrapper in ``counted``, and each segment's mean loss,
    kept samples a step, occupied share and ``probe()``'s dict, if given
    (``curve``, also printed)."""
    launches = dict.fromkeys(counted, 0)
    losses, n_samps, train_s, late_ms, update_ms, seg_s, curve = [], [], 0.0, None, None, 0.0, []
    while run.step < max_steps and train_s + seg_s <= budget_s:
        seg_start, seg_step, seg_end = train_s, run.step, min(run.step + segment, max_steps)
        w0 = (seg_end - 32) // 16 * 16 + 1
        for part, until in enumerate((w0, w0 + 15, w0 + 16, seg_end)):
            before = {k: w.launches for k, w in counted.items()}
            torch.cuda.synchronize()
            t = time.perf_counter()
            seg_losses, seg_n = train(until)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            for k, w in counted.items():
                launches[k] += w.launches - before[k]
            train_s += dt
            losses += seg_losses
            n_samps += seg_n
            if part == 1:
                late_ms = dt / 15 * 1e3
            elif part == 2:
                update_ms = dt * 1e3 - late_ms
        seg_s = train_s - seg_start
        seg_n = n_samps[-(run.step - seg_step):]
        extra = probe() if probe else {}
        curve.append(dict(step=run.step, train_s=train_s, loss=float(torch.stack(losses[-len(seg_n):]).mean()),
                          samples_per_step=float(torch.stack(seg_n).float().mean()),
                          occupied=float(run.occ_state.binaries.float().mean()), **extra))
        print(f"{label}: step={run.step} train_s={train_s:.3f} segment mean loss {curve[-1]['loss']:.6f}, "
              f"{curve[-1]['samples_per_step']:.1f} kept samples a step, occupied cells "
              f"{100 * curve[-1]['occupied']:.3f}%" + "".join(f", {k} {v:.6g}" for k, v in extra.items()), flush=True)
    return dict(losses=losses, n_samps=n_samps, train_s=train_s, late_ms=late_ms, update_ms=update_ms,
                launches=launches, curve=curve)


def counted_kernels() -> dict:
    """Every kernel wrapper, by its label, for the launch counts."""
    from nerfacc_tpu_torch.ops import table_grad as tg
    from nerfacc_tpu_torch.ops.occ_query import occupancy_query

    return {"K1": occupancy_query, "K2": tg.table_grad_u10, "K3": tg.cell_max, "K4-w3": tg.table_grad_w3,
            "K4-w8": tg.table_grad_w8, "K5": tg.table_grad_sorted, "K6": tg.table_grad_pos}


def check_launches(label, launches, n_steps, k1_per_step, n_k3) -> None:
    """K1 ``k1_per_step`` times a step, K3 ``n_k3`` times, nothing else."""
    want = dict.fromkeys(launches, 0)
    want.update(K1=k1_per_step * n_steps, K3=n_k3)
    if launches != want:
        fail(f"{label}: launches {launches} over {n_steps} steps, expected {want}")


def falling(label, losses) -> tuple:
    """The first and last loss; fails unless every loss is finite and the
    last 16 steps' mean is below the first 16 steps'."""
    first, last = float(losses[0]), float(losses[-1])
    if not all(math.isfinite(float(x)) for x in losses) or not (
            float(torch.stack(losses[-16:]).mean()) < float(torch.stack(losses[:16]).mean())):
        fail(f"{label}: losses not finite or not falling (first {first}, last {last})")
    return first, last


def gather_shares(label, prof) -> dict:
    """The profile's device milliseconds in each gather's backward range,
    in ``index_add_`` kernels (``indexFunc*``: every labelled gather's
    backward, ``gather_ray_od``'s and the pose rows'), in the backward of
    advanced indexing (``indexing_backward``: the scan's segment-start
    gather) and in the forward row gathers (``indexSelect*``)."""
    busy = prof["busy_ms"]
    out = {name: prof["stages"].get(name, 0.0) for name in GATHER_STAGES}
    for key, word in (("index_add_", "indexFunc"), ("indexing_backward", "indexing_backward"),
                      ("index_select", "indexSelect")):
        out[key] = sum(ms for name, (ms, _) in prof["kernels"].items() if word in name)
    print(f"{label} profile: " + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.1f}%)" for k, v in out.items())
          + f" of {busy:.3f} ms device time", flush=True)
    return dict(out, device_ms=busy)


def k1_on_a_late_step(train_one, run) -> dict:
    """:func:`k1_on_train_inputs` on one step that runs no occupancy update
    (the CLIs update before every 16th step, which would give the step a
    new grid): one more step first where the next would."""
    if run.step % 16 == 0:
        train_one()
    return k1_on_train_inputs(train_one, run.occ_state)


def step_card_vs_cpu(dev, label, step_fn, make_run, batch, loss_rtol, grad_tol, adam_eps, what) -> None:
    """``step_fn(run, *batch)`` on the card (``dev``) and on the CPU, each
    run from ``make_run(device)`` (the same weights and grid):
    :func:`hold_step`.  The parameters are the run's field's and, where it
    has one, its poser's."""
    res = []
    for device in (dev, torch.device("cpu")):
        run = make_run(device)
        modules = [run.field] + ([run.poser] if hasattr(run, "poser") else [])
        named = [(k, p) for m in modules for k, p in m.named_parameters()]
        before = {k: p.detach().cpu().clone() for k, p in named}
        t0 = time.perf_counter()
        out = step_fn(run, *(t.to(device) for t in batch))
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).detach().cpu() for k, p in named}
        decay = {id(p): g["weight_decay"] for g in run.opt.param_groups for p in g["params"]} if hasattr(run, "opt") else {}
        res.append(dict(
            loss=float(out[0]), n=int(out[1]), s=time.perf_counter() - t0, grads=grads,
            adam_grads={k: grads[k] + decay.get(id(p), 0.0) * before[k] for k, p in named},
            params={k: p.detach().cpu() for k, p in named},
        ))
    hold_step(label, res[0], res[1], loss_rtol, grad_tol, what, adam_eps=adam_eps, held_tols=10.0)


def train_plugin_field(dev, name, train_ds, test_ds, card_line) -> dict:
    """Phase 16 for one field: the occupancy CLI's ``train`` at the
    synthetic block (``PLUGIN_*``), launches counted, K1 and K3 on the
    phase's own inputs, a profile of three late steps, the eval views, and
    one step at 256 rays on the card against the CPU."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as cli

    cfg = cli.build_config("lego")  # the synthetic block

    def new_run(device, seed, cfg=cfg):
        est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=1)
        field = cli.make_field(cfg, est, field=name, device=device, generator=torch.Generator().manual_seed(seed))
        return cli.Run(cfg=cfg, field=field, estimator=est, occ_state=est.init(device),
                       opt=cli.make_optimizer(field, cfg["weight_decay"]), schedule=cli.lr_schedule(cfg["max_steps"]),
                       generator=torch.Generator(device=device).manual_seed(seed))

    t_field = time.perf_counter()
    cli.train(new_run(dev, 1), train_ds, 2)  # warm-up: cuBLAS handles, the allocator
    run = new_run(dev, 0)
    n_params = sum(p.numel() for p in run.field.parameters())
    _, use_skip, *_ = run.estimator.plan_traversal(cfg["render_step_size"], 0.0, cfg["near_plane"])
    k1_per_step = 1 + int(use_skip)
    torch.cuda.reset_peak_memory_stats()
    # The mean magnitude of the field's first factor (TensoRF's dp0, the
    # density plane over (x, y); K-Planes' sp0), each segment.
    first = next(run.field.named_parameters())

    def probe():
        return {f"{first[0]}_abs_mean": float(first[1].detach().abs().mean())}

    r = train_segments(name, lambda until: cli.train(run, train_ds, until), run, PLUGIN_MAX_STEPS, PLUGIN_BUDGET_S,
                       PLUGIN_SEGMENT, counted_kernels(), probe)
    n_steps, peak = run.step, torch.cuda.max_memory_allocated()
    n_updates = (n_steps + cli.OCC_EVERY - 1) // cli.OCC_EVERY
    check_launches(name, r["launches"], n_steps, k1_per_step, n_updates)
    first, last = falling(name, r["losses"])
    total = int(torch.stack(r["n_samps"]).sum())
    stages = ("fetch", "traverse_and_compact", "field_forward", "rendering", "backward", "optimizer",
              "occ_update") + GATHER_STAGES
    prof = profile_window(lambda: cli.train(run, train_ds, run.step + 3), stages,
                          f"{name} (3 steps from step {run.step})", f"profile_train_{name}.txt")
    shares = gather_shares(name, prof)
    k1 = k1_on_a_late_step(lambda: cli.train(run, train_ds, run.step + 1), run)
    k3 = k3_on_update_inputs(lambda: cli.occ_update(run, warmup=False), dev)
    metrics = cli.evaluate(run, test_ds, 8192)
    p_final = float(np.mean([m["psnr"] for m in metrics]))
    print(json.dumps({name: {
        "card": card_line, "params": n_params, "steps": n_steps, "train_s": r["train_s"],
        "late_step_ms": r["late_ms"], "update_ms": r["update_ms"], "samples_per_s": total / r["train_s"],
        "samples_per_ray": total / n_steps / cfg["num_rays"], "occupied": float(run.occ_state.binaries.float().mean()),
        "peak_bytes": peak, "loss_first": first, "loss_last": last, "eval_psnr": p_final,
        "eval_ssim": float(np.mean([m["ssim"] for m in metrics])), "k1_per_step": k1_per_step,
        "launches": {"K1": r["launches"]["K1"], "K3": r["launches"]["K3"]}, "profile": shares, "curve": r["curve"],
    }}), flush=True)
    print(f"{name}: {n_steps} steps in {r['train_s']:.3f} s, late step {r['late_ms']:.2f} ms, update "
          f"{r['update_ms']:.2f} ms, {total / r['train_s']:.1f} kept samples/s, loss first {first:.6f} last "
          f"{last:.6f}, eval PSNR {p_final:.4f} over {len(metrics)} views; K1 {r['launches']['K1']} "
          f"({k1_per_step} a step), K3 {r['launches']['K3']} ({n_updates} updates); max_memory_allocated {peak} B",
          flush=True)

    native_against_numpy(name, lambda until: cli.train(run, train_ds, until), run)

    # One step at 256 rays from the initial weights, card against CPU, with
    # 256 x 64 slots, on the grid of the initial weights' warm-up update (a
    # trained grid may hold no cell: TensoRF's density factors decay to 0
    # under the CLI's Adam, and a uniform field's cells tie with the mean).
    batch = train_ds[run.step]
    sel = slice(0, PLUGIN_CPU_RAYS)
    jitter = torch.from_numpy(np.random.default_rng(16).random(PLUGIN_CPU_RAYS, dtype=np.float32))
    small = dict(cfg, target_sample_batch_size=PLUGIN_CPU_RAYS * 64)
    warm = new_run(dev, 0)
    cli.occ_update(warm, warmup=True)
    weights = {k: v.detach().cpu().clone() for k, v in warm.field.state_dict().items()}

    def make_run(device):
        r = new_run(device, 0, small)
        r.field.load_state_dict(weights)
        r.occ_state = state_on(warm.occ_state, device)
        return r

    step_card_vs_cpu(dev, name, cli.train_step, make_run,
                     (batch["rays"].origins[sel], batch["rays"].viewdirs[sel], batch["pixels"][sel],
                      batch["color_bkgd"], jitter), MLP_LOSS_RTOL, PLUGIN_GRAD_TOL, 1e-15,
                     f"{PLUGIN_CPU_RAYS} rays, full width")
    print(f"phase 16 {name} took {time.perf_counter() - t_field:.1f} s", flush=True)
    return dict(launches=r["launches"], k1=k1, k3=k3)


def train_plugins(dev, card_line) -> dict:
    """Phase 16: TensoRF and K-Planes trained through the occupancy CLI on
    its procedural scene; returns each field's launches, K1 and K3."""
    from nerfacc_tpu_torch.datasets.procedural import make_loaders

    t_phase = time.perf_counter()
    train_ds, test_ds = make_loaders(num_rays=8192, width=PLUGIN_SIZE, height=PLUGIN_SIZE,
                                     n_train=PLUGIN_TRAIN_VIEWS, n_test=PLUGIN_TEST_VIEWS, device=dev)
    out = {name: train_plugin_field(dev, name, train_ds, test_ds, card_line) for name in PLUGIN_FIELDS}
    print(f"phase 16 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out




def train_barf_phase(dev, card_line) -> dict:
    """Phase 18: ``train_barf`` at its non-smoke widths with its schedules
    over ``BARF_MAX_STEPS`` steps (stopped at ``BARF_BUDGET_S`` of train
    time): the initial and refined pose errors, the eval views' PSNR, K1's
    launches held against its plain version on the phase's own inputs (no
    K3: a 64^3 grid draws 2^18 cells at most), a profile with the shares of
    ``gather_ray_od``'s backward and the scan's, and one step at 256 rays
    on the card against the CPU, the pose gradient included."""
    from nerfacc_tpu_torch.examples import train_barf as cli

    t_phase = time.perf_counter()
    cfg = cli.build_config(cli.parse_args(["--max_steps", str(BARF_MAX_STEPS)]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    data = cli.load_data(cfg, dev)
    print(f"barf data: {cfg['n_train']} + 2 views of {cfg['width']}x{cfg['width']} on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    _, rot0, tr0 = cli.align_poses(data["noisy_c2w"], data["gt_c2w"])
    cli.train(cli.make_run(cfg, data, dev, seed=1), data["train_rgba"], 2)  # warm-up
    run = cli.make_run(cfg, data, dev)
    _, use_skip, *_ = run.estimator.plan_traversal(cfg["render_step_size"], 0.0, cfg["near_plane"])
    k1_per_step = 1 + int(use_skip)
    torch.cuda.reset_peak_memory_stats()
    r = train_segments("barf", lambda until: cli.train(run, data["train_rgba"], until), run, BARF_MAX_STEPS,
                       BARF_BUDGET_S, BARF_SEGMENT, counted_kernels())
    n_steps, peak = run.step, torch.cuda.max_memory_allocated()
    launches = r["launches"]
    check_launches("barf", launches, n_steps, k1_per_step, 0)
    first, last = falling("barf", r["losses"])
    total = int(torch.stack(r["n_samps"]).sum())
    align, rot1, tr1 = cli.align_poses(cli.refined_poses(run), data["gt_c2w"])
    stages = ("fetch", "pose_rays", "traverse_and_compact", "field_forward", "rendering", "backward", "optimizer",
              "occ_update")
    prof = profile_window(lambda: cli.train(run, data["train_rgba"], run.step + 3), stages,
                          f"barf (3 steps from step {run.step})", "profile_train_barf.txt")
    shares = gather_shares("barf", prof)
    k1 = k1_on_a_late_step(lambda: cli.train(run, data["train_rgba"], run.step + 1), run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    psnrs = cli.evaluate(run, data["test_images"], data["test_c2w"], align)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    print(json.dumps({"barf": {
        "card": card_line, "max_steps": BARF_MAX_STEPS, "steps": n_steps, "train_s": r["train_s"],
        "late_step_ms": r["late_ms"], "update_ms": r["update_ms"], "samples_per_s": total / r["train_s"],
        "rays_per_s": n_steps * cfg["num_rays"] / r["train_s"], "peak_bytes": peak, "loss_first": first,
        "loss_last": last, "rot_err_deg": {"initial": float(rot0.mean()), "refined": float(rot1.mean())},
        "trans_err": {"initial": float(tr0.mean()), "refined": float(tr1.mean())}, "eval_psnr": psnrs,
        "eval_rays_per_s": len(psnrs) * cfg["width"] ** 2 / eval_s, "k1_per_step": k1_per_step,
        "launches": {"K1": launches["K1"], "K3": launches["K3"]}, "profile": shares, "curve": r["curve"],
    }}), flush=True)
    print(f"barf: {n_steps} of {BARF_MAX_STEPS} steps in {r['train_s']:.3f} s, late step {r['late_ms']:.2f} ms, "
          f"update {r['update_ms']:.2f} ms; pose error rot {rot1.mean():.4f} deg (initial {rot0.mean():.4f}), trans "
          f"{tr1.mean():.5f} (initial {tr0.mean():.5f}); eval PSNR {np.mean(psnrs):.4f}; loss first {first:.6f} "
          f"last {last:.6f}; K1 {launches['K1']} ({k1_per_step} a step), K3 {launches['K3']}", flush=True)
    if not rot1.mean() < rot0.mean():
        fail(f"barf: the refined rotation error {rot1.mean():.4f} deg is not below the initial {rot0.mean():.4f}")

    # One step at 256 rays from the initial weights and zero pose deltas on
    # the trained grid, card against CPU, the pose gradient included.
    rng = np.random.default_rng(18)
    n = MLP_CPU_RAYS
    cam_ids = torch.from_numpy(rng.integers(0, cfg["n_train"], n))
    px, py = (torch.from_numpy(rng.integers(0, cfg["width"], n).astype(np.float32)) for _ in range(2))
    rgba = data["train_rgba"].cpu()[cam_ids, py.long(), px.long()]
    bkgd = torch.from_numpy(rng.random(3, dtype=np.float32))
    pixels = rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])
    alpha = torch.tensor(cli.alpha_at(run.step, BARF_MAX_STEPS))
    jitter = torch.from_numpy(rng.random(n, dtype=np.float32))
    small = dict(cfg, sample_capacity=n * cfg["samples_per_ray"])
    cpu_data = dict(data, train_rgba=None)

    def make_run(device):
        r = cli.make_run(small, cpu_data, device)
        r.occ_state = state_on(run.occ_state, device)
        return r

    step_card_vs_cpu(dev, "BARF", cli.train_step, make_run, (cam_ids, px, py, pixels, bkgd, alpha, jitter),
                     MLP_LOSS_RTOL, PLUGIN_GRAD_TOL, 1e-8, f"{n} rays, full width, pose deltas included")
    print(f"phase 18 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=k1)


# Phase 19: a COLMAP capture of phase 12's textured procedural scene (192
# views on rings at three heights, radius 2.5; garden has 185) inside a
# textured backdrop sphere of radius 18 (sky, horizon and hills:
# surroundings at a finite distance, as a real capture's are, inside the
# outermost grid level once the cameras are normalised to radius 1, so
# that the free space before it is seen from every side),
# written as a Mip-NeRF 360 scene folder and trained through the occupancy
# CLI's own setup and loop (``--scene garden --data_root <capture>``): its
# unbounded block at full width (:61-71: 4 levels of 128^3, near 0.2, step
# 1e-3, cone 0.004, alpha threshold 1e-2; the fused field L8 x F16 with 2^18
# entries, float32; the 360 loader at factor 4; the port's dynamic ray count
# from 1024 up to 8192 rays, up to 2^21 traversal slots and 2^18 for the
# survivors, where the JAX example fixes 8192 rays and 2^18 slots),
# cut to CAPTURE_MAX_STEPS steps (the schedule's length) or CAPTURE_BUDGET_S
# of train time (90 s before the whole run passed 800 s).  The views of images_4/ are 504x336 (a real capture's
# factor-4 views are about 1297x840); images/ holds the same PNGs under
# COLMAP's names, as the loader reads only their names there.
CAPTURE_RINGS = ((64, -15.0), (64, -30.0), (64, -45.0))  # (views, elevation in degrees)
CAPTURE_W4, CAPTURE_H4, CAPTURE_RADIUS, CAPTURE_BACKDROP = 504, 336, 2.5, 18.0
CAPTURE_MAX_STEPS, CAPTURE_BUDGET_S, CAPTURE_SEGMENT = 3000, 50.0, 250
CAPTURE_GATE_DB = 24.0  # the eval-PSNR floor written before the first run
CAPTURE_SCENE = "garden"
JPEG_FIXTURES = "tests/fixtures/jpeg"


def sky(d: torch.Tensor) -> torch.Tensor:
    """The backdrop's texture at unit directions ``d`` from its centre (world
    up +y): a ground and a sky blended across the horizon, with a band of
    hills."""
    up = d[:, 1:2]
    s = torch.sigmoid(8.0 * up)
    ground = torch.tensor([0.35, 0.30, 0.22], device=d.device)
    blue = torch.tensor([0.55, 0.72, 0.95], device=d.device)
    hills = 0.08 * torch.sin(5.0 * torch.atan2(d[:, 2:3], d[:, 0:1])) * torch.exp(-30.0 * up * up)
    return (ground * (1 - s) + blue * s + hills).clamp(0.0, 1.0)


def qvec_from_rotation(R: np.ndarray) -> np.ndarray:
    """COLMAP's (w, x, y, z) of a rotation matrix."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.copysign(np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2, R[2, 1] - R[1, 2])
    y = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2, R[0, 2] - R[2, 0])
    z = np.copysign(np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2, R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


def write_capture(root, dev) -> dict:
    """Renders the capture on the card and writes ``root/CAPTURE_SCENE``:
    ``sparse/0/cameras.bin`` (one PINHOLE camera at 4x the views' size) and
    ``images.bin`` (OpenCV world-to-camera poses, in another order than the
    names), ``images_4/`` and ``images/`` (PNG).  Returns the timings."""
    import struct
    from pathlib import Path

    from nerfacc_tpu_torch.datasets.png import encode_png
    from nerfacc_tpu_torch.datasets.procedural import _render_pose_chunk, pose_spherical, scene_rgb_density
    from nerfacc_tpu_torch.datasets.utils import camera_rays

    scene = Path(root) / CAPTURE_SCENE
    for sub in ("sparse/0", "images", "images_4"):
        (scene / sub).mkdir(parents=True)
    w, h = CAPTURE_W4, CAPTURE_H4
    f = 0.9 * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    xx, yy = xx.reshape(-1).astype(np.float32), yy.reshape(-1).astype(np.float32)
    poses = []
    for r, (n, elev) in enumerate(CAPTURE_RINGS):
        for i in range(n):
            theta = 2 * np.pi * (i + 0.5 * r) / n
            poses.append(pose_spherical(theta, math.radians(elev), CAPTURE_RADIUS))  # OpenGL
    render_s = write_s = 0.0
    pngs = []
    for c2w in poses:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o, d = camera_rays(xx, yy, K, c2w[:3, :4], opengl=True)
        o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        parts = []
        for j in range(0, o.shape[0], 65536):
            color, opacity = _render_pose_chunk(o[j : j + 65536], d[j : j + 65536], CAPTURE_RADIUS - 1.2,
                                                CAPTURE_RADIUS + 1.2, lambda p: scene_rgb_density(p, 1.0))
            oj, dj = o[j : j + 65536], d[j : j + 65536]
            # The backdrop sphere's far hit (the cameras are inside it).
            b = (oj * dj).sum(-1, keepdim=True)
            t = -b + torch.sqrt(b * b - (oj * oj).sum(-1, keepdim=True) + CAPTURE_BACKDROP**2)
            hit = oj + t * dj
            parts.append(color + (1.0 - opacity) * sky(hit / hit.norm(dim=-1, keepdim=True)))
        rgb = (torch.cat(parts).clamp(0.0, 1.0) * 255).to(torch.uint8).cpu().numpy().reshape(h, w, 3)
        render_s += time.perf_counter() - t0
        t0 = time.perf_counter()
        pngs.append(encode_png(rgb))
        write_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    names = [f"IMG_{i:04d}.png" for i in range(len(poses))]
    for name, data in zip(names, pngs):
        (scene / "images_4" / name).write_bytes(data)
        (scene / "images" / name).write_bytes(data)
    with open(scene / "sparse/0/cameras.bin", "wb") as fh:
        fh.write(struct.pack("<Q", 1))
        fh.write(struct.pack("<iiQQ", 1, 1, 4 * w, 4 * h))  # model 1: PINHOLE
        fh.write(struct.pack("<4d", 4 * f, 4 * f, 4 * w / 2, 4 * h / 2))
    flip = np.diag([1.0, -1.0, -1.0, 1.0])  # OpenGL -> OpenCV camera axes
    order = np.random.default_rng(19).permutation(len(poses))
    with open(scene / "sparse/0/images.bin", "wb") as fh:
        fh.write(struct.pack("<Q", len(poses)))
        for img_id, i in enumerate(order, start=1):
            w2c = np.linalg.inv(poses[i].astype(np.float64) @ flip)
            fh.write(struct.pack("<I", img_id))
            fh.write(struct.pack("<4d", *qvec_from_rotation(w2c[:3, :3])))
            fh.write(struct.pack("<3d", *w2c[:3, 3]))
            fh.write(struct.pack("<I", 1))
            fh.write(names[i].encode() + b"\x00")
            fh.write(struct.pack("<Q", 0))
    write_s += time.perf_counter() - t0
    return dict(views=len(poses), render_s=render_s, write_s=write_s,
                bytes=sum(len(p) for p in pngs))


def jpeg_fixtures_on_card_machine() -> int:
    """Every committed JPEG fixture decoded by the port's host library, held
    bit-equal to its committed array (``imageio``'s decode)."""
    from pathlib import Path

    from nerfacc_tpu_torch.datasets.jpeg import read_jpeg

    paths = sorted((Path(__file__).resolve().parent / JPEG_FIXTURES).glob("*.jpg"))
    if len(paths) < 5:
        fail(f"jpeg fixtures: found {len(paths)} under {JPEG_FIXTURES}")
    for p in paths:
        got, want = read_jpeg(str(p)), np.load(p.with_suffix(".npy"))
        if got.shape != want.shape or not np.array_equal(got, want):
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max() if got.shape == want.shape else None
            fail(f"jpeg fixture {p.name}: the decode differs from its array (shape {got.shape} vs "
                 f"{want.shape}, max diff {diff})")
    print(f"jpeg fixtures: {len(paths)} decoded bit-equal to their arrays: {[p.name for p in paths]}", flush=True)
    return len(paths)


def native_sampler_on_card(dev) -> dict:
    """The native sampler where the script runs: built, taken by a procedural
    ``nerf_synthetic.SubjectLoader``'s training batch on the card (one
    ``sample_rays`` call a batch), its rays held against the numpy path's
    geometry (``tests/test_native.py:17``): unit directions through pixel
    centres of the ray's own view, the numpy path's ray at that pixel within
    1e-6, the camera's centre as origin, the pixel composited over the
    background.  Then a fetch's host ms through each path."""
    from nerfacc_tpu_torch.datasets import _native
    from nerfacc_tpu_torch.datasets.nerf_synthetic import SubjectLoader
    from nerfacc_tpu_torch.datasets.procedural import make_loaders
    from nerfacc_tpu_torch.datasets.utils import camera_rays

    t0 = time.perf_counter()
    _native.get_lib()
    build_s = time.perf_counter() - t0
    train_ds, _ = make_loaders(num_rays=8192, width=64, height=64, n_train=4, n_test=1, device=dev)
    train_ds.color_bkgd_aug = "random"
    real, calls = _native.sample_rays, []

    def counting(*args):
        calls.append(1)
        return real(*args)

    _native.sample_rays = counting
    try:
        batch = train_ds[0]
    finally:
        _native.sample_rays = real
    if len(calls) != 1 or batch["rays"].origins.device.type != "cuda":
        fail(f"native sampler: a training batch made {len(calls)} sample_rays calls, on "
             f"{batch['rays'].origins.device}")
    o, d, pix = (t.cpu().numpy().astype(np.float64) for t in (batch["rays"].origins, batch["rays"].viewdirs,
                                                               batch["pixels"]))
    bkgd = batch["color_bkgd"].cpu().numpy()
    ids = train_ds._last_image_id
    c2w = train_ds.camtoworlds[ids, :3, :4].astype(np.float64)
    K = train_ds.K.astype(np.float64)
    cam = np.einsum("nji,nj->ni", c2w[:, :, :3], d)  # R^T d, OpenGL: (a, -b, -1)
    px = cam[:, 0] / -cam[:, 2] * K[0, 0] + K[0, 2] - 0.5
    py = -cam[:, 1] / -cam[:, 2] * K[1, 1] + K[1, 2] - 0.5
    ix, iy = np.rint(px).astype(np.int64), np.rint(py).astype(np.int64)
    off = max(float(np.abs(px - ix).max()), float(np.abs(py - iy).max()))
    no, nd = camera_rays(ix.astype(np.float32), iy.astype(np.float32), train_ds.K, train_ds.camtoworlds[ids, :3, :4])
    rgba = train_ds.images[ids, iy, ix].astype(np.float64) / 255.0
    want = rgba[:, :3] * rgba[:, 3:] + bkgd * (1 - rgba[:, 3:])
    errs = dict(off_pixel_centre=off, dir=float(np.abs(nd - d).max()), origin=float(np.abs(no - o).max()),
                pixel=float(np.abs(want - pix).max()), norm=float(np.abs(np.linalg.norm(d, axis=-1) - 1).max()))
    print(f"native sampler: built/loaded in {build_s:.2f} s, {_native.num_threads()} OpenMP threads, one batch of "
          f"8192 rays through it; against the numpy path's geometry: {errs}", flush=True)
    if not (errs["off_pixel_centre"] < 1e-2 and errs["dir"] <= 1e-6 and errs["origin"] == 0.0
            and errs["pixel"] <= 1e-6 and errs["norm"] <= 1e-5):
        fail(f"native sampler: rays off the numpy path's geometry: {errs}")
    ms = {}
    for native in (True, False):
        SubjectLoader.NATIVE_SAMPLER = native
        try:
            train_ds[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(20):
                train_ds[i]
            torch.cuda.synchronize()
        finally:
            SubjectLoader.NATIVE_SAMPLER = True
        ms["native" if native else "numpy"] = (time.perf_counter() - t0) / 20 * 1e3
    print(f"native sampler: a fetch of 8192 rays onto the card takes {ms['native']:.3f} ms native, "
          f"{ms['numpy']:.3f} ms numpy (host clock, 20 fetches each)", flush=True)
    return dict(build_s=build_s, fetch_ms=ms, errs=errs)


def train_capture(dev, card_line) -> dict:
    """Phase 19: builds the host libraries, decodes the JPEG fixtures, checks
    the native sampler, writes the capture, loads it through the occupancy
    CLI's ``setup`` (the 360 loader) and trains it through the CLI's
    ``train``: launches counted and held to the path's (K1 2 a step, K4-w3
    1 a step, K3 4 an update), K1, K4-w3 and K3 held against their plain
    versions on the phase's own inputs, the filter's drop share, a profile
    of three late steps, the eval views' PSNR (the floor
    ``CAPTURE_GATE_DB``) and the loss falling."""
    import shutil
    import tempfile
    from pathlib import Path

    from nerfacc_tpu_torch.datasets.nerf_360_v2 import SubjectLoader as Capture
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator
    from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as cli
    from nerfacc_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    _build.build(_build.host_names())
    print(f"host libraries built in {time.perf_counter() - t0:.2f} s: {_build.host_names()}", flush=True)
    n_fixtures = jpeg_fixtures_on_card_machine()
    native = native_sampler_on_card(dev)

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    root = tempfile.mkdtemp(prefix="capture_360_", dir=build)
    try:
        cap = write_capture(root, dev)
        print(f"capture: {cap['views']} views of {CAPTURE_W4}x{CAPTURE_H4} rendered on the card in "
              f"{cap['render_s']:.2f} s, {cap['bytes']} bytes of PNG written in {cap['write_s']:.2f} s", flush=True)
        argv = ["--scene", CAPTURE_SCENE, "--data_root", root, "--max_steps", str(CAPTURE_MAX_STEPS)]
        args = cli.parse_args(argv)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run, train_ds, test_ds, chunk = cli.setup(args)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root)
    cfg = run.cfg
    if not (isinstance(train_ds, Capture) and isinstance(test_ds, Capture)):
        fail(f"capture: the CLI built {type(train_ds).__name__}, not nerf_360_v2.SubjectLoader")
    print(f"capture: loaded through the CLI's 360 loader in {load_s:.2f} s: {len(train_ds)} train and "
          f"{len(test_ds)} test views of {train_ds.WIDTH}x{train_ds.HEIGHT}, K {train_ds.K.tolist()}, camera "
          f"distances {np.linalg.norm(train_ds.camtoworlds[:, :3, 3], axis=-1).min():.4f} to "
          f"{np.linalg.norm(train_ds.camtoworlds[:, :3, 3], axis=-1).max():.4f}", flush=True)
    want_cfg = dict(grid_nlvl=4, grid_resolution=128, near_plane=0.2, render_step_size=1e-3, cone_angle=0.004,
                    alpha_thre=1e-2, num_rays=8192, target_sample_batch_size=1 << 18, unbounded=True,
                    dynamic_rays=True, traversal_capacity=1 << 21)
    if any(cfg[k] != v for k, v in want_cfg.items()):
        fail(f"capture: the CLI's block {({k: cfg[k] for k in want_cfg})} is not the unbounded one {want_cfg}")

    # Warm-up on a throwaway run of the same block: cuBLAS handles, the allocator.
    est = OccGridEstimator(roi_aabb=cfg["aabb"], resolution=cfg["grid_resolution"], levels=cfg["grid_nlvl"])
    field = cli.make_field(cfg, est, device=dev, generator=torch.Generator().manual_seed(1))
    cli.train(cli.Run(cfg=cfg, field=field, estimator=est, occ_state=est.init(dev),
                      opt=cli.make_optimizer(field, cfg["weight_decay"]), schedule=cli.lr_schedule(cfg["max_steps"]),
                      generator=torch.Generator(device=dev).manual_seed(1)), train_ds, 2)
    del est, field
    _, use_skip, *_ = run.estimator.plan_traversal(cfg["render_step_size"], cfg["cone_angle"], cfg["near_plane"])
    k1_per_step = 1 + int(use_skip)
    traversed = []
    make_fns = cli.make_fns

    def counting_fns(field, rays_o, rays_d):
        # The density pass's samples (the traversal's, before the filter).
        sigma_fn, rgb_sigma_fn = make_fns(field, rays_o, rays_d)

        def recorded(ts, te, ri):
            traversed.append((te > ts).sum())
            return sigma_fn(ts, te, ri)

        return recorded, rgb_sigma_fn

    # Each step's (traversed, visible, unslotted) sample counts, on the card.
    step_counts = []
    train_step = cli.train_step

    def counted_step(run_, *args):
        out = train_step(run_, *args)
        step_counts.append(run_.sample_counts)
        return out

    torch.cuda.reset_peak_memory_stats()
    cli.make_fns, cli.train_step = counting_fns, counted_step
    try:
        r = train_segments("capture", lambda until: cli.train(run, train_ds, until), run, CAPTURE_MAX_STEPS,
                           CAPTURE_BUDGET_S, CAPTURE_SEGMENT, counted_kernels(),
                           probe=lambda: {"num_rays": train_ds.num_rays, "traversal_slots": run.traversal_slots or 0})
    finally:
        cli.make_fns, cli.train_step = make_fns, train_step
    c = torch.stack(step_counts).double()
    slots = cfg["target_sample_batch_size"]
    # Steps whose traversal or survivors overflowed their slots (the last
    # rays then lose samples), and the share of samples so lost.
    short = dict(steps=float(((c[:, 2] > 0) | (c[:, 1] > slots)).double().mean()),
                 traversed_lost=float(c[:, 2].sum() / c[:, 0].sum()),
                 visible_lost=float((c[:, 1] - slots).clamp(min=0).sum() / c[:, 1].sum()))
    n_steps, peak = run.step, torch.cuda.max_memory_allocated()
    n_updates = (n_steps + cli.OCC_EVERY - 1) // cli.OCC_EVERY
    launches = r["launches"]
    want = dict.fromkeys(launches, 0)
    want.update({"K1": k1_per_step * n_steps, "K4-w3": n_steps, "K3": cfg["grid_nlvl"] * n_updates})
    if launches != want:
        fail(f"capture: launches {launches} over {n_steps} steps and {n_updates} updates, expected {want}")
    first, last = falling("capture", r["losses"])
    kept = int(torch.stack(r["n_samps"]).sum())
    drop = 1.0 - kept / max(int(torch.stack(traversed).sum()), 1)
    stages = ("fetch", "traverse_and_compact", "visibility", "field_forward", "gather_combine", "rendering",
              "backward", "table_grad", "optimizer", "occ_update")
    # Both windows of the profile (untraced, then traced) between two updates.
    cli.train(run, train_ds, run.step + (1 - run.step) % cli.OCC_EVERY)
    prof = profile_window(lambda: cli.train(run, train_ds, run.step + 3), stages,
                          f"capture (3 steps from step {run.step})", "profile_train_capture.txt")
    shares = gather_shares("capture", prof)
    fetch_ms = prof["host"]["fetch"] / 3
    k1 = k1_on_a_late_step(lambda: cli.train(run, train_ds, run.step + 1), run)
    if run.step % cli.OCC_EVERY == 0:
        cli.train(run, train_ds, run.step + 1)
    k4 = grad_kernel_on_step_inputs("K4-w3", "table_grad_w3", lambda: cli.train(run, train_ds, run.step + 1),
                                    "one capture step")
    k3 = k3_on_update_inputs(lambda: cli.occ_update(run, warmup=False), dev, levels=cfg["grid_nlvl"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = cli.evaluate(run, test_ds, chunk)
    eval_s = time.perf_counter() - t0
    p_final = float(np.mean([m["psnr"] for m in metrics]))
    print(json.dumps({"capture": {
        "card": card_line, "views": cap["views"], "size": [CAPTURE_W4, CAPTURE_H4], "train_views": len(train_ds),
        "test_views": len(test_ds), "load_s": load_s, "steps": n_steps, "train_s": r["train_s"],
        "late_step_ms": r["late_ms"], "update_ms": r["update_ms"], "samples_per_s": kept / r["train_s"],
        "kept_per_step": kept / n_steps, "num_rays_last": train_ds.num_rays,
        "traversal_slots_last": run.traversal_slots, "over_capacity": short, "drop_share": drop,
        "max_macro": run.max_macro,
        "occupied": float(run.occ_state.binaries.float().mean()), "peak_bytes": peak, "loss_first": first,
        "loss_last": last, "eval_psnr": p_final, "eval_psnr_views": [m["psnr"] for m in metrics],
        "eval_ssim": float(np.mean([m["ssim"] for m in metrics])), "eval_s": eval_s,
        "eval_rays_per_s": len(test_ds) * train_ds.WIDTH * train_ds.HEIGHT / eval_s, "fetch_host_ms": fetch_ms,
        "idle_share": 1.0 - prof["busy_ms"] / prof["wall_ms"], "k1_per_step": k1_per_step,
        "launches": {k: launches[k] for k in ("K1", "K4-w3", "K3")}, "profile": shares,
        "native_fetch_ms": native["fetch_ms"], "jpeg_fixtures": n_fixtures, "curve": r["curve"],
    }}), flush=True)
    print(f"capture: {n_steps} steps in {r['train_s']:.3f} s, late step {r['late_ms']:.2f} ms, update "
          f"{r['update_ms']:.2f} ms, {kept / r['train_s']:.1f} kept samples/s, the filter dropped {drop:.4f} of the "
          f"traversed samples, {short['steps']:.4f} of the steps over a capacity ({short['traversed_lost']:.2e} of "
          f"the traversed and {short['visible_lost']:.2e} of the visible samples lost), fetch {fetch_ms:.3f} ms "
          f"host; eval PSNR {p_final:.4f} over {len(metrics)} views "
          f"(floor {CAPTURE_GATE_DB}); loss first {first:.6f} last {last:.6f}; launches K1 {launches['K1']} "
          f"K4-w3 {launches['K4-w3']} K3 {launches['K3']}; max_memory_allocated {peak} B", flush=True)
    if not p_final >= CAPTURE_GATE_DB:
        fail(f"capture: eval PSNR {p_final:.4f} below the floor {CAPTURE_GATE_DB}")
    print(f"phase 19 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=k1, k3=k3, k4=k4)


# Phase 20: the two profiler scripts, each as ``python -m``, at bench.py's
# train configuration (TRAIN_*, bf16: K1, K2 and K3 on the path).
PROFILER_KERNELS = {"K1": "occ_query_kernel", "K2": "table_grad_u10_kernel", "K3": "cell_max_kernel"}


def profiler_tools() -> dict:
    """Phase 20: ``scripts.run_profiler`` at the bench configuration (3
    iterations a stage; every stage's time must be printed), then
    ``scripts.capture_trace`` over 3 steps and one occupancy update, whose
    ``parse`` table must name K1's, K2's and K3's kernels."""
    from pathlib import Path

    from nerfacc_tpu_torch.scripts import run_profiler

    t_phase = time.perf_counter()
    repo = Path(__file__).resolve().parent

    def script(name, *argv):
        """Runs the script; prints its first 20 lines and those that name K1,
        K2 or K3, and writes all of them to ``chiprun_out/<name>.txt``."""
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"nerfacc_tpu_torch.scripts.{name}", *argv], cwd=repo,
                              capture_output=True, text=True, timeout=300)
        lines = proc.stdout.splitlines()
        for i, line in enumerate(lines):
            if i < 20 or any(word in line for word in PROFILER_KERNELS.values()):
                print(f"{name}: {line}", flush=True)
        (repo / "chiprun_out").mkdir(exist_ok=True)
        (repo / "chiprun_out" / f"{name}.txt").write_text(proc.stdout)
        if proc.returncode != 0:
            fail(f"{name} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
        return proc.stdout, time.perf_counter() - t0

    bench = ["--rays", str(TRAIN_RAYS), "--capacity", str(TRAIN_CAPACITY), "--dtype", "bf16"]
    out, prof_s = script("run_profiler", *bench, "--iters", "3")
    stages = {}
    for line in out.splitlines():
        for name in run_profiler.STAGES:
            if line.startswith(name) and line.rstrip().endswith(" ms"):
                stages[name] = float(line[len(name):].split()[0])
    missing = [s for s in run_profiler.STAGES if s not in stages]
    if missing:
        fail(f"run_profiler: no time for the stages {missing}")
    trace_dir = repo / "build" / "phase20_trace"
    # Every kernel of the window in the table (K1 is one of the shortest).
    out, trace_s = script("capture_trace", *bench, "--steps", "3", "--occ-update", "--top", "1000",
                          "--out", str(trace_dir))
    table = [line for line in out.splitlines() if " ms  " in line]
    named = {k: any(word in line for line in table) for k, word in PROFILER_KERNELS.items()}
    if not all(named.values()):
        fail(f"capture_trace: its table names no kernel of {[k for k, v in named.items() if not v]}")
    total = [line for line in out.splitlines() if line.startswith("total device kernel time")]
    print(f"profiler tools: run_profiler {prof_s:.1f} s (every stage timed, full step "
          f"{stages['FULL train step']:.2f} ms), capture_trace {trace_s:.1f} s ({total[0] if total else '?'}; "
          f"names K1, K2 and K3); phase 20 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(stages=stages)


# Phase 21: nerfacc_tpu_torch.parallel.  (a) A world of one over NCCL at
# phase 6's configuration (bench.py's full width: 16384 rays, 2^19 slots,
# the res-128 shell, the fused L4 x F16 encoder in bf16, macro budget 4).
# (b) Two processes on the one card over gloo (NCCL refuses two ranks on one
# device), each holding half of 1024 rays at the full field width in float32,
# as a correctness run: 2^16 slots a rank, not phase 8's 2^15, because 512
# rays take ~37,000 samples (72 a ray) and a shard that overflows keeps other
# samples than one process on the union of the rays would.
PAR_B_RAYS, PAR_B_CAPACITY, PAR_B_RENDER_RAYS = 1024, 1 << 16, 4096
# The parallel steps against one process's (phase 21a: phase 6's
# train_step on the same weights, jitter and batch; 21b: one process on the
# union of the rays, float32 sums of ~37,000 samples' terms in another
# grouping): the loss, and every gradient relative to its largest entry,
# within 1e-5 (2.24e-07 and 3.27e-07 measured on an H100); the parameters
# after Adam within 1e-6 where the gradients' signs agree.  The views of
# the parallel renderer against occgrid_render_rays_test within 1e-5 (the
# same rounds; index_add_'s atomics order each ray's sums; 1.8e-07
# measured).
PAR_TOL, PAR_RENDER_ATOL = 1e-5, 1e-5


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def step_record(field, loss, n_samp) -> dict:
    """A step's kept samples, loss, gradients and parameters after Adam."""
    return dict(
        n=int(n_samp), loss=float(loss),
        grads={k: p.grad.detach().to("cpu", torch.float32, copy=True) for k, p in field.named_parameters()},
        params={k: p.detach().to("cpu", copy=True) for k, p in field.named_parameters()},
    )


def same_grid(label, a, b) -> None:
    """Two occupancy states: ``occs``, the binaries and every derived grid equal."""
    diffs = {k: int((getattr(a, k) != getattr(b, k)).sum())
             for k in ("occs", "binaries", "binaries_packed", "skip_grid", "skip_packed")}
    print(f"{label}: entries that differ {diffs}, occupied {int(a.binaries.sum())}", flush=True)
    if any(diffs.values()):
        fail(f"{label}: the grids differ")


def view_rays(dev) -> tuple:
    """Phase 3's 800x800 view: its origins and directions, flattened."""
    from nerfacc_tpu_torch.datasets.procedural import pose_spherical
    from nerfacc_tpu_torch.datasets.utils import generate_rays

    c2w = pose_spherical(math.radians(-30.0), math.radians(-30.0), 4.0)[:3, :4]
    K = np.array([[FOCAL, 0, WIDTH / 2], [0, FOCAL, HEIGHT / 2], [0, 0, 1]], np.float32)
    xs, ys = np.meshgrid(np.arange(WIDTH), np.arange(HEIGHT), indexing="xy")
    rays = generate_rays(xs, ys, K, c2w, device=dev)
    return rays.origins.reshape(-1, 3).contiguous(), rays.viewdirs.reshape(-1, 3).contiguous()


def field_builder(field):
    """``occgrid_render_rays_test``'s builder for ``field``."""
    from nerfacc_tpu_torch.rendering import gather_ray_od

    def builder(ro, rd):
        def rgb_sigma_fn(ts, te, ri):
            o, d = gather_ray_od(ro, rd, ri)
            rgb, sigma = field(o + ((ts + te) / 2)[:, None] * d, d)
            return rgb, sigma[..., 0]

        return rgb_sigma_fn

    return builder


def same_view(label, got, want, atol) -> float:
    """Two renders ``(rgb, opacity, depth)``: rgb and opacity within ``atol``,
    depth within ``atol`` relative.  Returns the largest rgb difference."""
    errs = [float((a - b).abs().max()) for a, b in zip(got[:2], want[:2])]
    d_err = float(((got[2] - want[2]).abs() / want[2].abs().clamp(min=1.0)).max())
    print(f"{label}: rgb max abs err {errs[0]:.3e}, opacity {errs[1]:.3e}, depth rel {d_err:.3e} (tol {atol})",
          flush=True)
    if max(errs + [d_err]) > atol:
        fail(f"{label}: the views differ")
    return errs[0]


def parallel_world_of_one(dev, card_line, phase6=None) -> dict:
    """Phase 21a: ``nerfacc_tpu_torch.parallel`` over NCCL in a world of one
    at phase 6's configuration: one parallel step against phase 6's
    ``train_step`` and one parallel update against ``_update`` (same
    weights, jitter, batch and draws), then 3 warm-up and 30 timed steps and
    8 timed updates (step and update ms beside phase 6's, samples/s, peak
    memory, the gradient buffer's bytes), a profile window with the
    ``all_reduce``'s ms, K1, K2 and K3 on the path's own inputs, and the
    800x800 view through ``make_parallel_test_renderer`` against
    ``occgrid_render_rays_test``; K1, K2 and K3 counted over the timed
    steps, updates and view.  Returns the launches and the kernels' numbers
    for the kernel table."""
    import os

    import torch.distributed as dist

    from nerfacc_tpu_torch.ops.occ_query import occupancy_query
    from nerfacc_tpu_torch.ops.table_grad import cell_max, table_grad_u10
    from nerfacc_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_parallel_occ_update, make_parallel_test_renderer,
        make_parallel_train_step, replicate, shard_rays,
    )
    from nerfacc_tpu_torch.rendering import occgrid_render_rays_test

    t_phase = time.perf_counter()
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # a world of one needs no network
    if initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl") != (0, 1):
        fail("parallel: the NCCL world of one did not join as rank 0 of 1")
    if dist.get_backend() != "nccl":
        fail(f"parallel: joined over {dist.get_backend()}, not NCCL")
    mesh = make_mesh(device=dev)
    bkgd = torch.ones(3, device=dev)
    jitter = torch.rand((TRAIN_RAYS,), generator=torch.Generator(device=dev).manual_seed(21), device=dev)
    draws = None
    records, grids = [], []
    for parallel in (True, False):
        est, state, field, opt, (rays_o, rays_d), pixels = bench_setup(dev, TRAIN_FIELD_CFG, torch.bfloat16)
        if draws is None:
            draws = est.make_draws(10**9, torch.Generator(device=dev).manual_seed(5), device=dev)
        if parallel:
            replicate(field, mesh)
            replicate(opt, mesh)
            state = replicate(state, mesh)
            o, d, px = shard_rays((rays_o, rays_d, pixels), mesh)
            step = make_parallel_train_step(field, est, opt, mesh, render_step_size=STEP, near_plane=0.0,
                                            sample_capacity_per_shard=TRAIN_CAPACITY, max_macro_segments=TRAIN_MACRO)
            update = make_parallel_occ_update(field, est, mesh, render_step_size=STEP)
            grids.append(update(state, draws=draws))
            loss, n_samp = step(state, o, d, px, bkgd, jitter=jitter)
            par = (est, state, field, opt, o, d, px, step, update)
        else:
            grids.append(occ_update(est, state, field, draws=draws))
            loss, n_samp, _ = train_step(field, opt, est, state, rays_o, rays_d, pixels, jitter, TRAIN_CAPACITY)
        records.append(step_record(field, loss, n_samp))
    hold_step("NCCL, world of 1", *records, PAR_TOL, PAR_TOL, f"{TRAIN_RAYS} rays, capacity {TRAIN_CAPACITY}",
              sides="parallel vs phase 6's")
    same_grid("parallel update (NCCL, world of 1) vs _update on the same draws", *grids)
    same_grid("parallel update's derived grids vs set_binaries of its binaries", grids[0],
              par[0].set_binaries(grids[0], grids[0].binaries))
    del records, grids
    est, state, field, opt, o, d, px, step, update = par
    gen = torch.Generator(device=dev).manual_seed(0)

    def one_step():
        return step(state, o, d, px, bkgd, jitter=torch.rand((TRAIN_RAYS,), generator=gen, device=dev))

    def one_update():
        return update(state)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    occupancy_query.launches = cell_max.launches = table_grad_u10.launches = 0
    losses = [one_step()[0] for _ in range(3)]
    one_update()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n_samps = []
    for _ in range(TRAIN_ITERS):
        loss, n_samp = one_step()
        losses.append(loss)
        n_samps.append(n_samp)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_ITERS
    t0 = time.perf_counter()
    for _ in range(TRAIN_UPDATES):
        new_state = one_update()
    torch.cuda.synchronize()
    update_s = (time.perf_counter() - t0) / TRAIN_UPDATES
    launches = {"K1": occupancy_query.launches, "K2": table_grad_u10.launches, "K3": cell_max.launches}
    total = int(torch.stack(n_samps).sum())
    sps = total / (TRAIN_ITERS * step_s + TRAIN_ITERS / 16.0 * update_s)
    peak = torch.cuda.max_memory_allocated()
    grad_bytes = 4 * (sum(p.numel() for p in field.parameters()) + 3)
    p6 = ""
    if phase6:
        p6 = f" (phase 6: step {phase6['step_ms']:.2f} ms, update {phase6['update_ms']:.2f} ms, {phase6['sps']:.1f} samples/s)"
    print(f"parallel train (NCCL, world of 1, {card_line}): step {step_s * 1e3:.2f} ms, occupancy update "
          f"{update_s * 1e3:.2f} ms{p6}, {sps:.1f} samples/s ({total} samples in {TRAIN_ITERS} steps), "
          f"launches {launches}, max_memory_allocated {peak} B, gradient buffer {grad_bytes} B, "
          f"loss first {float(losses[0]):.6f} last {float(losses[-1]):.6f}, occupied after an update "
          f"{int(new_state.binaries.sum())}", flush=True)
    if not all(math.isfinite(float(x)) for x in losses):
        fail("parallel train: a loss is not finite")
    if launches["K1"] <= 0 or launches["K2"] < TRAIN_ITERS + 3 or launches["K3"] < TRAIN_UPDATES + 1:
        fail(f"parallel train: kernels launched too few times on the path: {launches}")

    def steps_and_update():
        for _ in range(3):
            one_step()
        one_update()

    prof = profile_window(
        steps_and_update,
        ("traverse_and_compact", "field_forward", "gather_combine", "rendering", "backward", "table_grad",
         "all_reduce", "optimizer", "occ_update"),
        "parallel train (NCCL, world of 1; 3 steps and 1 update)", "profile_train_parallel.txt",
    )
    nccl = {k: v for k, v in prof["kernels"].items() if "nccl" in k.lower()}
    ar_ms, ar_host_ms = prof["stages"]["all_reduce"], prof["host"]["all_reduce"]
    print(f"parallel all_reduce (4 in the window: 3 steps' gradients of {grad_bytes} B, one update's two merges): "
          f"device {ar_ms:.4f} ms in its range, host {ar_host_ms:.3f} ms traced; NCCL kernels {nccl}", flush=True)
    k1 = k1_on_train_inputs(one_step, state)
    k2 = grad_kernel_on_step_inputs("K2", "table_grad_u10", one_step, "one parallel step's inputs")
    k3 = k3_on_update_inputs(one_update, dev)

    # The 800x800 view through the parallel renderer and the single-process one.
    field.eval()
    o_view, d_view = view_rays(dev)
    render = make_parallel_test_renderer(field, est, mesh, **RENDER_KW)
    torch.cuda.synchronize()
    occupancy_query.launches = cell_max.launches = table_grad_u10.launches = 0
    t0 = time.perf_counter()
    rgb, opacity, depth, rounds = render(new_state, o_view, d_view, render_bkgd=bkgd)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    render_launches = {"K1": occupancy_query.launches, "K2": table_grad_u10.launches, "K3": cell_max.launches}
    if render_launches["K1"] <= 0 or render_launches["K2"] or render_launches["K3"]:
        fail(f"parallel render: expected K1 launches and no other, saw {render_launches}")
    launches["K1"] += render_launches["K1"]
    t0 = time.perf_counter()
    want = occgrid_render_rays_test(field_builder(field), est, new_state, o_view, d_view, render_bkgd=bkgd,
                                    **RENDER_KW)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    print(f"parallel render (NCCL, world of 1): 800x800 in {rounds} rounds, {render_s:.3f} s = "
          f"{o_view.shape[0] / render_s:.1f} rays/s (occgrid_render_rays_test {single_s:.3f} s), "
          f"mean opacity {float(opacity.mean()):.4f}, K1 launches {render_launches['K1']} "
          f"(the path's launches, steps, updates and render: {launches})", flush=True)
    same_view("parallel render vs occgrid_render_rays_test", (rgb, opacity, depth), want[:3], PAR_RENDER_ATOL)
    if not (bool(torch.isfinite(rgb).all()) and rounds >= 1):
        fail("parallel render: not finite, or no round")
    dist.destroy_process_group()
    print(f"phase 21a took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, k1=k1, k2=k2, k3=k3, step_ms=step_s * 1e3, update_ms=update_s * 1e3, sps=sps,
                render_rays_s=o_view.shape[0] / render_s, rounds=rounds, all_reduce_ms=ar_ms,
                all_reduce_host_ms=ar_host_ms)


def parallel_b_inputs(dev) -> dict:
    """Phase 21b's inputs, made once on the CPU: the float32 field's seed-0
    weights, 1024 rays and pixels, each rank's jitter, each rank's update
    draws (uniform draws with given ranks, which concatenate into one
    update's draws) and the rays of the render."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator

    _, _, field, _, _, _ = bench_setup(dev, TRAIN_FIELD_CFG, None)
    rng = np.random.default_rng(21)
    d = rng.normal(size=(PAR_B_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1, skip_factor=2)
    shell = shell_binaries(GRID_RES)
    gen = torch.Generator().manual_seed(21)
    n = est.cells_per_lvl // 4
    draws = [[{
        "uniform": torch.randint(0, est.cells_per_lvl, (n,), generator=gen),
        "ranks": torch.randint(0, int(shell.sum()), (n,), generator=gen),
        "jitter": torch.rand((2 * n, 3), generator=gen),
    }] for _ in range(2)]
    o_view, d_view = view_rays(torch.device("cpu"))
    pick = torch.from_numpy(rng.choice(o_view.shape[0], PAR_B_RENDER_RAYS, replace=False))
    return dict(
        weights={k: v.cpu() for k, v in field.state_dict().items()},
        rays_o=torch.from_numpy(-3.0 * d), rays_d=torch.from_numpy(d),
        pixels=torch.from_numpy(rng.random((PAR_B_RAYS, 3), dtype=np.float32)),
        jitter=[torch.from_numpy(rng.random(PAR_B_RAYS // 2, dtype=np.float32)) for _ in range(2)],
        draws=draws, shell=torch.from_numpy(shell), view_o=o_view[pick], view_d=d_view[pick],
    )


def parallel_b_setup(dev, inp):
    """Phase 21b's estimator, shell state (zero occupancies) and float32
    field with the inputs' weights, and Adam."""
    from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator

    est = OccGridEstimator(roi_aabb=AABB, resolution=GRID_RES, levels=1, skip_factor=2)
    state = est.set_binaries(est.init(dev), inp["shell"])
    field = ngp_field(TRAIN_FIELD_CFG, None, dev)
    field.load_state_dict({k: v.to(dev) for k, v in inp["weights"].items()})
    return est, state, field, torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)


def parallel_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of phase 21b: joins the gloo world of two on the one card,
    then one parallel step on its half of the rays, one parallel update on
    its own draws and the parallel render, with K1, K3 and K4-w3 counted in
    each: K4-w3 once in the step, K3 once in the update (one level), K1 in
    the step and the render, nothing else.  Then two more steps and one
    more update hold K1 and K4-w3 on rank 0's step inputs and K3 on its
    update's draws (rank 1 runs them too, for their collectives).  Writes
    its results."""
    from pathlib import Path

    import torch.distributed as dist

    from nerfacc_tpu_torch.ops.occ_query import occupancy_query
    from nerfacc_tpu_torch.ops.table_grad import cell_max, table_grad_w3
    from nerfacc_tpu_torch.parallel import (
        initialize_distributed, make_mesh, make_parallel_occ_update, make_parallel_test_renderer,
        make_parallel_train_step, replicate, shard_rays,
    )

    inp = torch.load(Path(out_dir) / "inputs.pt", weights_only=False)
    dev = torch.device(inp["device"])
    torch.backends.cuda.matmul.allow_tf32 = False
    if initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo") != (rank, 2):
        fail(f"parallel worker {rank}: did not join as rank {rank} of 2")
    mesh = make_mesh(device=dev)
    counted = {"K1": occupancy_query, "K3": cell_max, "K4-w3": table_grad_w3}
    launches, ms = {}, {}

    def counted_run(what, fn):
        for kernel in counted.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        ms[what] = (time.perf_counter() - t0) * 1e3
        launches[what] = {name: kernel.launches for name, kernel in counted.items()}
        n = launches[what]
        if not ((n["K1"] > 0) == (what != "update") and n["K4-w3"] == (what == "step")
                and n["K3"] == (what == "update")):
            fail(f"parallel worker {rank}: launches in the {what} {n}")
        return result

    est, state, field, opt = parallel_b_setup(dev, inp)
    replicate(field, mesh)
    state = replicate(state, mesh)
    o, d, px = shard_rays((inp["rays_o"], inp["rays_d"], inp["pixels"]), mesh)
    bkgd, jitter = torch.ones(3, device=dev), inp["jitter"][mesh.index].to(dev)
    step = make_parallel_train_step(field, est, opt, mesh, render_step_size=STEP, near_plane=0.0,
                                    sample_capacity_per_shard=PAR_B_CAPACITY, max_macro_segments=TRAIN_MACRO)
    loss, n_samp = counted_run("step", lambda: step(state, o, d, px, bkgd, jitter=jitter))
    out = dict(step=step_record(field, loss, n_samp))
    update_field = parallel_b_setup(dev, inp)[2]  # the update and the render on the initial weights
    update = make_parallel_occ_update(update_field, est, mesh, render_step_size=STEP)
    draws = inp["draws"][mesh.index]
    new = counted_run("update", lambda: update(state, draws=draws))
    out["update"] = {k: getattr(new, k).cpu() for k in ("occs", "binaries", "binaries_packed", "skip_grid",
                                                         "skip_packed")}
    update_field.eval()
    render = make_parallel_test_renderer(update_field, est, mesh, **RENDER_KW)
    rgb, opacity, depth, rounds = counted_run(
        "render", lambda: render(state, inp["view_o"].to(dev), inp["view_d"].to(dev), render_bkgd=bkgd))
    out.update(render=(rgb.cpu(), opacity.cpu(), depth.cpu(), rounds), ms=ms, launches=launches)

    def again():
        return step(state, o, d, px, bkgd, jitter=jitter)

    def update_again():
        return update(state, draws=draws)

    if mesh.index == 0:
        out["kernels"] = dict(
            k1=k1_on_train_inputs(again, state),
            k4=grad_kernel_on_step_inputs("K4-w3", "table_grad_w3", again, "one 2-rank step's inputs (rank 0)"),
            k3=k3_on_update_inputs(update_again, dev),
        )
    else:
        for fn in (again, again, update_again):
            fn()
    dist.destroy_process_group()
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def parallel_two_ranks(dev) -> dict:
    """Phase 21b: two processes on the one card over gloo, each a rank
    holding half of the rays: the 2-rank step against one process's step
    on the union of the rays, the 2-rank update against one process's
    ``_update`` on the union of the draws (the occupancies, from zero, are
    the probes' max) and the OR of each rank's own binaries, and the 2-rank
    render against ``occgrid_render_rays_test``.  A correctness run: the
    times are two processes sharing one card."""
    import os
    from pathlib import Path

    from nerfacc_tpu_torch.rendering import occgrid_render_rays_test

    t_phase = time.perf_counter()
    out_dir = Path(__file__).resolve().parent / "build" / "phase21b"
    out_dir.mkdir(parents=True, exist_ok=True)
    inp = parallel_b_inputs(dev)
    torch.save(dict(inp, device=str(dev)), out_dir / "inputs.pt")
    port = free_port()
    env = dict(os.environ, GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"))
    procs = []
    # Each rank's output to a file (a pipe nobody reads could fill); a rank
    # that fails ends the other, which would wait in a collective.
    for r in range(2):
        with open(out_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--parallel-worker", str(r), str(port), str(out_dir)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
    deadline = time.perf_counter() + 300
    try:
        while any(p.poll() is None for p in procs) and time.perf_counter() < deadline:
            if any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    logs = [(out_dir / f"rank{r}.log").read_text() for r in range(2)]
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"parallel rank {r} of 2 (gloo) exited {p.returncode}:\n{log[-4000:]}")
    print("".join(f"rank 0: {line}\n" for line in logs[0].splitlines()), end="", flush=True)
    outs = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(2)]
    spawn_s = time.perf_counter() - t_phase
    launches = {k: sum(o["launches"][what][k] for o in outs for what in o["launches"]) for k in ("K1", "K3", "K4-w3")}
    print(f"parallel (gloo, 2 ranks): launches per rank {[o['launches'] for o in outs]}; over both ranks "
          f"{launches}", flush=True)
    for key in ("step", "update"):
        a, b = (o[key] for o in outs)
        same = a["n"] == b["n"] and a["loss"] == b["loss"] if key == "step" else all(
            torch.equal(a[k], b[k]) for k in a)
        if not same:
            fail(f"parallel (gloo, 2 ranks): the ranks' {key} results differ")

    # One process on the union: the step on all the rays with both jitters.
    est, state, field, opt = parallel_b_setup(dev, inp)
    o, d, px = (inp[k].to(dev) for k in ("rays_o", "rays_d", "pixels"))
    loss, n_samp, extras = train_step(field, opt, est, state, o, d, px, torch.cat(inp["jitter"]).to(dev),
                                      2 * PAR_B_CAPACITY)
    single = step_record(field, loss, n_samp)
    if int(extras["n_over_capacity"]) != 0:
        fail("parallel (gloo, 2 ranks): the union overflows its slots")
    hold_step("gloo, 2 ranks on one card", outs[0]["step"], single, PAR_TOL, PAR_TOL,
              f"{PAR_B_RAYS} rays, {PAR_B_CAPACITY} slots a rank", sides="parallel vs one process on the union")

    # One process's update on the union of the draws, and on each rank's.
    field = parallel_b_setup(dev, inp)[2]
    q = est.cells_per_lvl // 4
    draws = [r[0] for r in inp["draws"]]
    union = [{"uniform": torch.cat([x["uniform"] for x in draws]), "ranks": torch.cat([x["ranks"] for x in draws]),
              "jitter": torch.cat([x["jitter"][:q] for x in draws] + [x["jitter"][q:] for x in draws])}]
    one = occ_update(est, state, field, draws=union, draw_mode="uniform")
    each = [occ_update(est, state, field, draws=[x], draw_mode="uniform") for x in draws]
    got = outs[0]["update"]
    occ_err = float((got["occs"] - one.occs.cpu()).abs().max())
    occ_each_err = float((got["occs"] - torch.maximum(each[0].occs, each[1].occs).cpu()).abs().max())
    want_bin = (each[0].binaries | each[1].binaries).cpu()
    rebuilt = est._grids(got["binaries"])
    print(f"parallel update (gloo, 2 ranks): occs vs one update on the union of the draws max abs err {occ_err:.3e}, "
          f"vs the max of each rank's {occ_each_err:.3e}; binaries equal to the OR of each rank's "
          f"{torch.equal(got['binaries'], want_bin)}; derived grids rebuilt from the merged binaries "
          f"{all(torch.equal(got[k], rebuilt[k]) for k in ('binaries_packed', 'skip_grid', 'skip_packed'))}",
          flush=True)
    # The probes' densities in two batches against one: the field's GEMMs may
    # take other tilings at another row count, so allow 1e-6 of the largest.
    scale = float(one.occs.abs().max())
    if (occ_err > 1e-6 * scale or occ_each_err > 1e-6 * scale or not torch.equal(got["binaries"], want_bin)
            or not all(torch.equal(got[k], rebuilt[k]) for k in ("binaries_packed", "skip_grid", "skip_packed"))):
        fail("parallel update (gloo, 2 ranks) disagrees with one process")

    # The render against the single-process renderer on the same rays.
    field.eval()
    want = occgrid_render_rays_test(field_builder(field), est, state, inp["view_o"].to(dev), inp["view_d"].to(dev),
                                    render_bkgd=torch.ones(3, device=dev), **RENDER_KW)
    rgb_err = same_view("parallel render (gloo, 2 ranks) vs occgrid_render_rays_test", outs[0]["render"][:3],
                        [t.cpu() for t in want[:3]], PAR_RENDER_ATOL)
    ms = outs[0]["ms"]
    print(f"parallel (gloo, 2 ranks on one card; a correctness run, not scaling): step {ms['step']:.1f} ms, "
          f"update {ms['update']:.1f} ms, render of {PAR_B_RENDER_RAYS} rays {ms['render']:.1f} ms "
          f"({outs[0]['render'][3]} rounds), first calls; the two processes took {spawn_s:.1f} s; "
          f"phase 21b took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(occ_err=occ_err, rgb_err=rgb_err, ms=ms, launches=launches, kernels=outs[0]["kernels"])


def parallel_phase(dev, card_line, phase6=None) -> dict:
    """Phase 21: (a) then (b)."""
    t0 = time.perf_counter()
    a = parallel_world_of_one(dev, card_line, phase6)
    b = parallel_two_ranks(dev)
    print(f"phase 21 took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(a, b=b)


ALL_PHASES = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21)
# A phase that needs another's results: serve needs phase 2's grid, the crop
# the served field, and phase 8 the weights trained in phases 6 and 7.
NEEDS = {3: (2,), 4: (3,), 8: (6, 7)}


def parse_phases(argv) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument(
        "--phases", default=",".join(map(str, ALL_PHASES)),
        help="comma-separated phases to run (default: all; phase 1 always runs)",
    )
    args = ap.parse_args(argv)
    try:
        run = {int(p) for p in args.phases.split(",") if p.strip()} | {1}
    except ValueError:
        ap.error(f"--phases: not a list of numbers: {args.phases!r}")
    if not run <= set(ALL_PHASES):
        ap.error(f"--phases: phases are {ALL_PHASES}")
    for phase, need in NEEDS.items():
        if phase in run and not set(need) <= run:
            ap.error(f"--phases: phase {phase} needs phase(s) {need}")
    return tuple(sorted(run))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    if argv[:1] == ["--parallel-worker"]:  # one rank of phase 21b
        parallel_worker(int(argv[1]), int(argv[2]), argv[3])
        return
    run = parse_phases(argv)
    from nerfacc_tpu_torch.ops import _build
    from nerfacc_tpu_torch.ops.table_grad import table_grad_pos, table_grad_u10, table_grad_w3

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
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}; phases {run}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s: {_build.kernel_names()}", flush=True)
    for label, name in (("K1", "occ_query"), ("K2", "table_grad_u10"), ("K3", "cell_max"), ("K4", "table_grad"),
                        ("K6", "table_grad_pos")):
        for line in _build.ptxas_report(name).splitlines():
            if any(word in line for word in ("Compiling entry", "Used", "spill")):
                print(f"{label} ptxas: {line.replace('ptxas info    :', '').strip()}", flush=True)

    # ---- 2. K1 against its plain version; 3. serve; 4. crop against CPU ---
    if 2 in run:
        est, state, k1 = k1_vs_plain(dev)
    if 3 in run:
        serve_rays_s = serve(dev, est, state, crop=4 in run)

    # ---- 5. the table-gradient kernels and K3 against their plain versions --
    if 5 in run:
        kt = kernels_vs_plain(dev)

    # ---- 6. train at full width ---------------------------------------------
    phase6 = {}
    if 6 in run:
        trained, train_launches, k1_train_err, train_step_ms = train_full_width(
            dev, TRAIN_FIELD_CFG, table_grad_u10, "K2", "profile_train.txt", check_inputs=True, details=phase6
        )
        phase6["step_ms"] = train_step_ms

    # ---- 7. train at full width, tcnn shape (grouped encoder) ---------------
    if 7 in run:
        grouped, grouped_launches, _, _ = train_full_width(
            dev, GROUPED_FIELD_CFG, table_grad_pos, "K6", "profile_train_grouped.txt", check_inputs=False
        )

    # ---- 8. train steps, card against CPU -----------------------------------
    def weights(field):
        return {k: v.detach().clone() for k, v in field.state_dict().items()}

    if 8 in run:
        route_launches = train_card_vs_cpu(dev, weights(trained), weights(grouped))

    # ---- 9. train at full width in float32 (K4-w3) ---------------------------
    if 9 in run:
        _, f32_launches, _, _ = train_full_width(
            dev, TRAIN_FIELD_CFG, table_grad_w3, "K4-w3", "profile_train_f32.txt", check_inputs=False,
            compute_dtype=None,
        )

    # ---- 10. train and eval, unbounded, with the visibility filter ---------
    if 10 in run:
        unb = train_unbounded(dev)

    # ---- 11. train and eval, the proposal-network path --------------------
    if 11 in run:
        prop = train_prop(dev)

    # ---- 12. the first trained scene: bench.py's quality run ---------------
    if 12 in run:
        quality = train_quality(dev, card_line)
        print(f"quality against the random fields: late step {quality['late_step_ms']:.2f} ms"
              + (f" (phase 6: {train_step_ms:.2f} ms)" if 6 in run else "")
              + f"; serve {quality['serve_rays_s']:.1f} rays/s on the trained grid"
              + (f" (phase 3, random field: {serve_rays_s:.1f})" if 3 in run else ""), flush=True)

    # ---- 13. the vanilla NeRF, trained; 14. T-NeRF and NDR ---------------
    if 13 in run:
        mlp = train_mlp(dev, card_line)
    if 14 in run:
        tn = train_dynamic(dev, card_line, "tnerf")

    # ---- 15. the other encoders, the SoA route, the macro-skip traversal ---
    if 15 in run:
        enc = train_encoders(dev, train_step_ms if 6 in run else None)

    # ---- 16. TensoRF and K-Planes; 17. TiNeuVox; 18. BARF -----------------
    if 16 in run:
        plug = train_plugins(dev, card_line)
    if 17 in run:
        tnv = train_dynamic(dev, card_line, "tineuvox")
    if 18 in run:
        barf = train_barf_phase(dev, card_line)

    # ---- 19. a COLMAP capture, loaded and trained; 20. the profiler tools --
    if 19 in run:
        capture = train_capture(dev, card_line)
    if 20 in run:
        profiler_tools()

    # ---- 21. parallel/: NCCL in a world of one; two gloo ranks on one card --
    if 21 in run:
        par = parallel_phase(dev, card_line, phase6 or None)

    print(card_line, flush=True)  # nvidia-smi's name and power limit
    if run == ALL_PHASES:
        # K1's launches here are the fused train path's (phase 6); the serve
        # path's are printed in phase 3.  K2, K3: phase 6; K6: phase 7; K4-w3
        # in float32: the float32 train path (phase 9); K4's other modes and
        # K5: their routes' card steps in phase 8.
        src = "nerfacc_tpu_torch/csrc/"
        tg_py = "nerfacc_tpu/ops/table_grad.py:"
        k6_paths = {(2, 4): grouped_launches["K6"], (2, 2): route_launches["grouped bf16 split 2"],
                    (2, 8): route_launches["grouped bf16 split 8"]}
        kernels = [
            kernel_row("occupancy_query", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                       train_launches["K1"], max(k1["err"], k1_train_err), k1["ms"], k1["plain_ms"],
                       k1["bytes"], k1["ops"], None),
        ] + [
            kernel_row(name, src + file, tg_py + line, launches, kt[key]["err"], kt[key]["ms"],
                       kt[key]["plain_ms"], kt[key]["bytes"], kt[key]["ops"], kt[key].get("library_ms"))
            for name, key, file, line, launches in (
                ("table_grad_u10", "K2", "table_grad_u10.cu", "749", train_launches["K2"]),
                ("table_grad_w3", "K4-w3", "table_grad.cu", "572", f32_launches["K4-w3"]),
                ("table_grad_w3_bf16", "K4-w3-bf16", "table_grad.cu", "572", route_launches["w3 bf16"]),
                ("table_grad_w8_bf16", "K4-w8-bf16", "table_grad.cu", "572", route_launches["w8 bf16"]),
                ("table_grad_w8", "K4-w8", "table_grad.cu", "572", route_launches["w8 float32"]),
                ("table_grad_sorted", "K5", "table_grad_sorted.cu", "245", route_launches["pallas bf16"]),
                # The pallas route launches K5 once a level (phase 8): one
                # level's shape.
                ("table_grad_sorted_level", "K5-level", "table_grad_sorted.cu", "245",
                 route_launches["pallas bf16"]),
                ("cell_max", "K3", "cell_max.cu", "1918", train_launches["K3"]),
            )
        ] + [
            # Every K6 instance at the grouped train shape: the default split's
            # launches from phase 7's train path, splits 2 and 8 at F = 2 from
            # phase 8's steps, the others from the grouped encoder's own
            # backward in phase 5.
            kernel_row(k6_row_name(F, k), src + "table_grad_pos.cu", tg_py + "1488",
                       k6_paths.get((F, k), kt[key]["launches"]), kt[key]["err"], kt[key]["ms"], kt[key]["plain_ms"],
                       kt[key]["bytes"], kt[key]["ops"], None)
            for F, k in K6_INSTANCES for key in (k6_label(F, k),)
        ] + [
            # K1 and K3 again on the unbounded train path (phase 10): K1 on
            # one step's 4-level lattice queries, K3 at 2^23 cells on one
            # update's draws.
            kernel_row("occupancy_query_unbounded", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                       unb["launches"]["K1"], unb["k1"]["err"], unb["k1"]["lattice"]["ms"],
                       unb["k1"]["lattice"]["plain_ms"], unb["k1"]["lattice"]["bytes"],
                       unb["k1"]["lattice"]["ops"], None),
            kernel_row("cell_max_unbounded", src + "cell_max.cu", tg_py + "1918", unb["launches"]["K3"],
                       unb["k3"]["err"], unb["k3"]["ms"], unb["k3"]["plain_ms"], unb["k3"]["bytes"],
                       unb["k3"]["ops"], unb["k3"]["library_ms"]),
            # K4-w3 again on the proposal-network train path (phase 11), on
            # one step's own inputs.
            kernel_row("table_grad_w3_prop", src + "table_grad.cu", tg_py + "572", prop["launches"],
                       prop["k4"]["err"], prop["k4"]["ms"], prop["k4"]["plain_ms"], prop["k4"]["bytes"],
                       prop["k4"]["ops"], None),
            # K1 and K2 on the trained scene's path (phase 12), each on one
            # late step's own inputs.
            kernel_row("occupancy_query_quality", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                       quality["launches"]["K1"], quality["k1"]["err"], quality["k1"]["lattice"]["ms"],
                       quality["k1"]["lattice"]["plain_ms"], quality["k1"]["lattice"]["bytes"],
                       quality["k1"]["lattice"]["ops"], None),
            kernel_row("table_grad_u10_quality", src + "table_grad_u10.cu", tg_py + "749",
                       quality["launches"]["K2"], quality["k2"]["err"], quality["k2"]["ms"],
                       quality["k2"]["plain_ms"], quality["k2"]["bytes"], quality["k2"]["ops"], None),
            # K1 and K3 on the vanilla NeRF's path (phase 13), each on its own
            # inputs (one late step's queries, one update's draws).
            kernel_row("occupancy_query_mlp", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                       mlp["launches"]["K1"], mlp["k1"]["err"], mlp["k1"]["lattice"]["ms"],
                       mlp["k1"]["lattice"]["plain_ms"], mlp["k1"]["lattice"]["bytes"], mlp["k1"]["lattice"]["ops"],
                       None),
            kernel_row("cell_max_mlp", src + "cell_max.cu", tg_py + "1918", mlp["launches"]["K3"], mlp["k3"]["err"],
                       mlp["k3"]["ms"], mlp["k3"]["plain_ms"], mlp["k3"]["bytes"], mlp["k3"]["ops"],
                       mlp["k3"]["library_ms"]),
            # K1 on the hash encoder's path (phase 15a, one step's lattice
            # queries); K2 and K3 on the SoA route (phase 15b, one step's
            # and one update's own inputs).
            kernel_row("occupancy_query_hash", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                       enc["launches"]["K1"], enc["k1"]["err"], enc["k1"]["lattice"]["ms"],
                       enc["k1"]["lattice"]["plain_ms"], enc["k1"]["lattice"]["bytes"], enc["k1"]["lattice"]["ops"],
                       None),
            kernel_row("table_grad_u10_soa", src + "table_grad_u10.cu", tg_py + "749", enc["soa"]["launches"]["K2"],
                       enc["soa"]["k2"]["err"], enc["soa"]["k2"]["ms"], enc["soa"]["k2"]["plain_ms"],
                       enc["soa"]["k2"]["bytes"], enc["soa"]["k2"]["ops"], None),
            kernel_row("cell_max_soa", src + "cell_max.cu", tg_py + "1918", enc["soa"]["launches"]["K3"],
                       enc["soa"]["k3"]["err"], enc["soa"]["k3"]["ms"], enc["soa"]["k3"]["plain_ms"],
                       enc["soa"]["k3"]["bytes"], enc["soa"]["k3"]["ops"], enc["soa"]["k3"]["library_ms"]),
        ]
        # K1 and K3 on the T-NeRF path (phase 14), the plug-in fields'
        # paths (phases 16 and 17) and the capture's (19): one late step's
        # lattice queries, one update's draws; K1 on BARF's (18).
        paths = [("tnerf", tn)] + [(name, plug[name]) for name in PLUGIN_FIELDS] + [
            ("tineuvox", tnv), ("barf", barf), ("capture", capture)]
        for name, p in paths:
            lat = p["k1"]["lattice"]
            kernels.append(kernel_row(f"occupancy_query_{name}", src + "occ_query.cu",
                                      "nerfacc_tpu/ops/occ_query.py:121", p["launches"]["K1"], p["k1"]["err"],
                                      lat["ms"], lat["plain_ms"], lat["bytes"], lat["ops"], None))
            if "k3" in p:
                k3 = p["k3"]
                kernels.append(kernel_row(f"cell_max_{name}", src + "cell_max.cu", tg_py + "1918",
                                          p["launches"]["K3"], k3["err"], k3["ms"], k3["plain_ms"], k3["bytes"],
                                          k3["ops"], k3["library_ms"]))
        # K4-w3 on the capture's train path (phase 19), on one step's own inputs.
        k4 = capture["k4"]
        kernels.append(kernel_row("table_grad_w3_capture", src + "table_grad.cu", tg_py + "572",
                                  capture["launches"]["K4-w3"], k4["err"], k4["ms"], k4["plain_ms"], k4["bytes"],
                                  k4["ops"], None))
        # K1, K2 and K3 on the parallel train path (phase 21a), each on its own
        # inputs (one parallel step's queries and table gradient, one update's draws).
        lat, k2, k3 = par["k1"]["lattice"], par["k2"], par["k3"]
        kernels += [
            kernel_row("occupancy_query_parallel", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                       par["launches"]["K1"], par["k1"]["err"], lat["ms"], lat["plain_ms"], lat["bytes"], lat["ops"],
                       None),
            kernel_row("table_grad_u10_parallel", src + "table_grad_u10.cu", tg_py + "749", par["launches"]["K2"],
                       k2["err"], k2["ms"], k2["plain_ms"], k2["bytes"], k2["ops"], None),
            kernel_row("cell_max_parallel", src + "cell_max.cu", tg_py + "1918", par["launches"]["K3"], k3["err"],
                       k3["ms"], k3["plain_ms"], k3["bytes"], k3["ops"], k3["library_ms"]),
        ]
        # K1, K4-w3 (float32) and K3 on the two gloo ranks' path (phase 21b),
        # launches over both ranks, each held on rank 0's own inputs.
        b = par["b"]
        k1, k4, k3 = b["kernels"]["k1"], b["kernels"]["k4"], b["kernels"]["k3"]
        lat = k1["lattice"]
        kernels += [
            kernel_row("occupancy_query_parallel_gloo", src + "occ_query.cu", "nerfacc_tpu/ops/occ_query.py:121",
                       b["launches"]["K1"], k1["err"], lat["ms"], lat["plain_ms"], lat["bytes"], lat["ops"], None),
            kernel_row("table_grad_w3_parallel_gloo", src + "table_grad.cu", tg_py + "572", b["launches"]["K4-w3"],
                       k4["err"], k4["ms"], k4["plain_ms"], k4["bytes"], k4["ops"], None),
            kernel_row("cell_max_parallel_gloo", src + "cell_max.cu", tg_py + "1918", b["launches"]["K3"], k3["err"],
                       k3["ms"], k3["plain_ms"], k3["bytes"], k3["ops"], k3["library_ms"]),
        ]
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
