"""Where the time of kernels K1, K2, K3, K4 and K6 goes on one NVIDIA GPU.

    python3 kernel_variants.py            # every kernel
    python3 kernel_variants.py k1 k3      # some of them

Builds variants of a kernel's source, each with one part changed by a text
substitution, into ``build/kernel_variants/`` and times each on
``chip_smoke.py``'s inputs (phase 2's for K1, phase 5's for the others),
three rounds in turn, with ``chip_smoke.time_ms``.  Every time includes what
the wrapper launches: for K2, K4 and K6 the ``torch.zeros`` of the output
and the kernel (for K6 also the positions' pre-pass).  The variants that keep
the function are held against the plain version.

K1 (``csrc/occ_query.cu``; 4096 x 256 render-shaped queries on the 128^3
shell):

- ``kernel``: the source as it is.
- ``launch only``: every block returns at once, which leaves the launch.
- ``no grid reads``: the grid-word index stands in for the word, so no
  dependent read follows the coordinates (the result is wrong).
- ``scalar coordinate loads``: four 4-byte loads a coordinate, not one
  16-byte load.
- ``a block per 1024 queries``: the grid is not cut to one wave.
- ``128 threads a block``.

K2 (``csrc/table_grad_u10.cu``; 2^21 sample-levels over 4 x 2^15 rows):

- ``kernel``: the source as it is.
- ``staging only``: the walk removed; a block stages its tile and stops.
- ``tiles of 512``: 512-sample tiles of 128 threads, four blocks an SM
  (the same shared memory).
- ``four blocks an SM``, ``twelve blocks an SM``: the shared memory split
  for that many resident blocks.
- ``no run fast path``: every sample of a quad tested for a new row, also
  where the quad's last row is the current run's.
- ``cotangents past L1``: the cotangent gathers with
  ``ld.global.nc.L1::no_allocate`` instead of ``__ldg``.
- ``in-order cotangents``: a sample reads the cotangent at its own place in
  the sorted order instead of the permutation's, which shows what the
  random gather costs (the result is wrong).

K3 (``csrc/cell_max.cu``; 2^20 draws into 2^21 cells, each variant on phase
5's draws, on the same draws sorted by id and on ``sysrow``-shaped draws,
into an output filled with -1 beforehand; the wrapper, which fills it with
``torch.full`` first, and the fill alone are timed beside them):

- ``kernel``: the source as it is, one ``atomicMax`` a draw into device
  memory.
- ``launch only``: every block returns at once.
- ``four draws a thread``: 16-byte loads of the ids and values.
- ``fill and atomics in one cooperative launch``: the -1 fill and the
  atomics in one kernel, across a grid-wide barrier (so it needs no
  ``torch.full``).

K4 (``csrc/table_grad.cu``; K2's inputs in K4's four modes, w3 and w8 in
float32 and bf16, each variant on each mode):

- ``kernel``, ``staging only``, ``no run fast path``: as for K2.
- ``float32 tiles of 256``: 256-sample float32 tiles of 64 threads, four
  blocks an SM (about the same shared memory; the tile check dropped); the
  bf16 modes as they are.
- ``float32 at six blocks an SM``, ``bf16 at twelve blocks an SM``: the
  shared memory split for that many resident blocks of one type.

K6 (``csrc/table_grad_pos.cu``; 2^19 samples x 8 fetches over 2 x 2^16
rows):

- ``kernel``, ``staging only``, ``seven blocks an SM``, ``in-order
  cotangents``: as for K2.
- ``three position arrays``: a pair gathers x, y and z from the three
  input arrays, not one packed 16 B record.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

K2_WALK = "  // ---- 2. the walk: warp w sums samples [sb, se) of the tile --------------\n"
K2_STAGE_ONLY = K2_WALK + (
    "  if ((tid & 31) == 0 && (tid >> 5) * kWarpSamples < count) {\n"
    "    const int q0 = (tid >> 5) * kWarpSamples / 4;\n"
    "    out[blockIdx.x * 4 + (tid >> 5)] = __uint_as_float(st.w[q0][0].x) +\n"
    "        static_cast<float>(st.key[q0].x) + __uint_as_float(st.d[q0][0].x);\n"
    "  }\n"
    "  return;\n"
)
K4_STAGE_ONLY = K2_WALK + (
    "  if ((tid & 31) == 0 && (tid >> 5) * kWarpSamples < count) {\n"
    "    const int q0 = (tid >> 5) * kWarpSamples / 4;\n"
    "    out[blockIdx.x * 4 + (tid >> 5)] = static_cast<float>(st.key[q0].x) +\n"
    "        reinterpret_cast<const float*>(&st.w[q0][0])[0] + reinterpret_cast<const float*>(&st.d[q0][0])[0];\n"
    "  }\n"
    "  return;\n"
)
K4_TILE_CHECK = "  if (tile != Stage::kSamples ||"
K4_F32_TILE = "constexpr int kTileF32 = 128;"
K4_F32_BLOCKS = "constexpr int kBlocksPerSmF32 = 8;"
K4_BF16_BLOCKS = "constexpr int kBlocksPerSmBf16 = 8;"
K6_WALK = "  // ---- 2. the walk: walker v sums pairs [sb, se) of the tile --------------\n"
K6_STAGE_ONLY = K6_WALK + (
    "  constexpr int kWarpPairs = kTile / (kThreads / 32);\n"
    "  if ((tid & 31) == 0 && (tid >> 5) * kWarpPairs < count) {\n"
    "    const int q0 = (tid >> 5) * kWarpPairs / 4;\n"
    "    out[blockIdx.x * 8 + (tid >> 5)] = __uint_as_float(st.w[q0][0].x) +\n"
    "        static_cast<float>(st.dst[4 * q0]) + __uint_as_float(st.d[q0][0].x);\n"
    "  }\n"
    "  return;\n"
)
K2_BLOCKS = "constexpr int kBlocksPerSm = 8;"
K2_GATHER = "      da[r] = __ldg(dout + 2 * p[r]);\n      db[r] = __ldg(dout + 2 * p[r] + 1);\n"
K2_HELPERS = "// The 8 bf16 corner weights of the u10 word q.\n"
K2_LOAD_PAST_L1 = (
    "__device__ __forceinline__ uint4 ld_past_l1(const uint4* p) {\n"
    "  uint4 v;\n"
    "  asm(\"ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\"\n"
    "      : \"=r\"(v.x), \"=r\"(v.y), \"=r\"(v.z), \"=r\"(v.w) : \"l\"(p));\n"
    "  return v;\n"
    "}\n\n" + K2_HELPERS
)
K1_WORD_READ = "      word[k][dp] = __ldg(g.packed + ((mp * g.rx + ix) * g.ry + iy) * g.words + (iz >> 5));\n"
K1_COORDS = (
    "    const float4 x4 = __ldg(reinterpret_cast<const float4*>(px) + q);\n"
    "    const float4 y4 = __ldg(reinterpret_cast<const float4*>(py) + q);\n"
    "    const float4 z4 = __ldg(reinterpret_cast<const float4*>(pz) + q);\n"
)
K1_BLOCKS = "  const int blocks = static_cast<int>(want < 1 ? 1 : (want < wave ? want : wave));\n"
K3_LAUNCH = (
    "  cell_max_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
    "      ids, vals, reinterpret_cast<int*>(out), n, n_cells);\n"
)
K3_NAMESPACE_END = "}  // namespace\n"
K3_FOUR = """__global__ void four_kernel(const int4* __restrict__ ids, const float4* __restrict__ vals,
                            int* __restrict__ out_bits, int64_t quads, int n_cells) {
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; q < quads;
       q += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int4 a = __ldg(ids + q);
    const float4 v = __ldg(vals + q);
    const int id[4] = {a.x, a.y, a.z, a.w};
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (id[k] < 0 || id[k] >= n_cells) continue;
      int bits = __float_as_int(x[k]);
      if (bits == INT_MIN) bits = 0;
      atomicMax(out_bits + id[k], bits);
    }
  }
}

"""
K3_FOUR_LAUNCH = (
    "  four_kernel<<<static_cast<int>((n / 4 + threads - 1) / threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
    "      reinterpret_cast<const int4*>(ids), reinterpret_cast<const float4*>(vals), reinterpret_cast<int*>(out), n / 4,\n"
    "      n_cells);\n"
)
# Candidate (a): the -1 fill and the atomics in one cooperative launch,
# across a grid-wide barrier.
K3_COOP = """__global__ void fill_and_place_kernel(const int32_t* __restrict__ ids, const float* __restrict__ vals,
                                      int* __restrict__ out_bits, int64_t n, int n_cells) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int m = __float_as_int(-1.0f);
  for (int64_t i = first; i < n_cells / 4; i += stride) reinterpret_cast<int4*>(out_bits)[i] = make_int4(m, m, m, m);
  for (int64_t i = n_cells / 4 * 4 + first; i < n_cells; i += stride) out_bits[i] = m;
  cooperative_groups::this_grid().sync();
  for (int64_t i = first; i < n; i += stride) {
    const int id = __ldg(ids + i);
    if (id < 0 || id >= n_cells) continue;
    int bits = __float_as_int(__ldg(vals + i));
    if (bits == INT_MIN) bits = 0;
    atomicMax(out_bits + id, bits);
  }
}

"""
K3_COOP_LAUNCH = """  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fill_and_place_kernel, threads, 0);
  int* out_bits = reinterpret_cast<int*>(out);
  void* args[] = {&ids, &vals, &out_bits, &n, &n_cells};
  cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fill_and_place_kernel), sms * per_sm, threads, args, 0,
                              static_cast<cudaStream_t>(stream));
"""


# kernel -> (source name, ((variant name, keeps the function, substitutions), ...))
VARIANTS = {
    "k1": ("occ_query", (
        ("kernel", True, ()),
        ("launch only", False, (("  Box b;\n", "  if (n > 0) return;\n  Box b;\n"),)),
        ("no grid reads", False, ((K1_WORD_READ, K1_WORD_READ.replace("__ldg(g.packed + ", "(")),)),
        ("scalar coordinate loads", True, ((K1_COORDS, "".join(
            f"    const float4 {a}4 = make_float4(__ldg(p{a} + 4 * q), __ldg(p{a} + 4 * q + 1), "
            f"__ldg(p{a} + 4 * q + 2), __ldg(p{a} + 4 * q + 3));\n" for a in "xyz")),)),
        ("a block per 1024 queries", True, ((K1_BLOCKS, "  const int blocks = static_cast<int>(want < 1 ? 1 : want);\n"),)),
        ("128 threads a block", True, (("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),)),
    )),
    "k2": ("table_grad_u10", (
        ("kernel", True, ()),
        ("staging only", False, ((K2_WALK, K2_STAGE_ONLY),)),
        ("tiles of 512", True, (
            ("constexpr int kTile = 256;", "constexpr int kTile = 512;"),
            ("if (tile != kTile ||", "if (tile != 256 ||"),
            (K2_BLOCKS, "constexpr int kBlocksPerSm = 4;"),
        )),
        ("four blocks an SM", True, ((K2_BLOCKS, "constexpr int kBlocksPerSm = 4;"),)),
        ("twelve blocks an SM", True, ((K2_BLOCKS, "constexpr int kBlocksPerSm = 12;"),)),
        ("no run fast path", True, (("    if (k4.w == cur && 4 * qd + 4 <= se) {", "    if (false) {"),)),
        ("cotangents past L1", True, (
            (K2_HELPERS, K2_LOAD_PAST_L1), (K2_GATHER, K2_GATHER.replace("__ldg", "ld_past_l1")),
        )),
        ("in-order cotangents", False, ((K2_GATHER, (
            "      da[r] = __ldg(dout + 2 * (begin + i0 + r));\n"
            "      db[r] = __ldg(dout + 2 * (begin + i0 + r) + 1);\n")),)),
    )),
    "k3": ("cell_max", (
        ("kernel", True, ()),
        ("launch only", False, (("  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;\n",
                                 "  if (n > 0) return;\n  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;\n"),)),
        ("four draws a thread", True, ((K3_NAMESPACE_END, K3_FOUR + K3_NAMESPACE_END), (K3_LAUNCH, K3_FOUR_LAUNCH))),
        ("fill and atomics in one cooperative launch", True, (
            ('#include "common.cuh"\n', '#include <cooperative_groups.h>\n\n#include "common.cuh"\n'),
            (K3_NAMESPACE_END, K3_COOP + K3_NAMESPACE_END), (K3_LAUNCH, K3_COOP_LAUNCH),
        )),
    )),
    "k4": ("table_grad", (
        ("kernel", True, ()),
        ("staging only", False, ((K2_WALK, K4_STAGE_ONLY),)),
        ("float32 tiles of 256", True, (
            (K4_F32_TILE, "constexpr int kTileF32 = 256;"),
            (K4_F32_BLOCKS, "constexpr int kBlocksPerSmF32 = 4;"),
            (K4_TILE_CHECK, "  if (false ||"),
        )),
        ("float32 at six blocks an SM", True, ((K4_F32_BLOCKS, "constexpr int kBlocksPerSmF32 = 6;"),)),
        ("bf16 at twelve blocks an SM", True, ((K4_BF16_BLOCKS, "constexpr int kBlocksPerSmBf16 = 12;"),)),
        ("no run fast path", True, (("    if (k4.w == cur && 4 * qd + 4 <= se) {", "    if (false) {"),)),
    )),
    "k6": ("table_grad_pos", (
        ("kernel", True, ()),
        ("staging only", False, ((K6_WALK, K6_STAGE_ONLY),)),
        ("seven blocks an SM", True, (("constexpr int kBlocksPerSm = 4;", "constexpr int kBlocksPerSm = 7;"),)),
        ("three position arrays", True, (
            ("const float4* __restrict__ pos,\n",
             "const float4* __restrict__ pos, const float* __restrict__ xs,\n"
             "const float* __restrict__ ys, const float* __restrict__ zs,\n"),
            ("q[m] = __ldg(pos + s);", "q[m] = make_float4(__ldg(xs + s), __ldg(ys + s), __ldg(zs + s), 0.f);"),
            ("const float4* pos,\n           const void* dout,",
             "const float4* pos, const float* xs, const float* ys, const float* zs,\n           const void* dout,"),
            ("sorted_key, perm, pos, dout, out,", "sorted_key, perm, pos, xs, ys, zs, dout, out,"),
            ("(sorted_key, perm, p4, dout,", "(sorted_key, perm, p4, xs, ys, zs, dout,"),
        )),
        ("in-order cotangents", False, (("load_cot<C>(dout, p[m], dv[m]);", "load_cot<C>(dout, begin + i, dv[m]);"),)),
    )),
}


def build(kernel: str, out_dir: Path) -> dict:
    """Each variant's source, compiled by nvcc in parallel into a library."""
    from nerfacc_tpu_torch.ops import _build

    source, variants = VARIANTS[kernel]
    src = (_build.CSRC / f"{source}.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, _, subs) in enumerate(variants):
        text = src
        for old, new in subs:
            if old not in text:
                cs.fail(f"{kernel} variant {name!r}: {old!r} is not in the source")
            text = text.replace(old, new)
        cu, so = out_dir / f"{kernel}_v{i}.cu", out_dir / f"{kernel}_v{i}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            cs.fail(f"{kernel} variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.nerfacc_cuda_error_string.argtypes = [ctypes.c_int]
        lib.nerfacc_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _zeros_aside(n_rows, dev) -> dict:
    return {"torch.zeros of the output alone": lambda: torch.zeros((n_rows, 128), device=dev)}


def k1_run(dev):
    """K1 on phase 2's render-shaped queries (4096 rays x 256 steps on the
    128^3 shell): the inputs (one here), each a function that launches a
    library's kernel and the plain version's result; the launch functions'
    argument types by name; and what is timed beside the variants."""
    from nerfacc_tpu_torch.ops import _build
    from nerfacc_tpu_torch.ops import occ_query as oq

    _, state, base, (px, py, pz) = cs.k1_render_inputs(dev, np.random.default_rng(0))
    packed = state.binaries_packed
    levels, rx, ry, words = packed.shape

    def run(lib):
        out = torch.empty(px.shape, dtype=torch.bool, device=dev)
        rc = lib.occ_query_launch(px.data_ptr(), py.data_ptr(), pz.data_ptr(), packed.data_ptr(), base.data_ptr(),
                                  out.data_ptr(), px.numel(), levels, rx, ry, cs.GRID_RES, words, 0,
                                  torch.cuda.current_stream().cuda_stream)
        _build.check(lib, rc, "occ_query_launch")
        return out

    want = oq.occupancy_query_plain(packed, base, px, py, pz, rz=cs.GRID_RES)
    return {"": (run, want)}, {"occ_query_launch": oq._launcher()[1].argtypes}, {
        "the plain version": lambda: oq.occupancy_query_plain(packed, base, px, py, pz, rz=cs.GRID_RES),
    }


def k3_run(dev):
    """K3 on phase 5's draws (2^20 into 2^21 cells), on the same draws
    sorted by id, and on ``sysrow``-shaped draws (a uniform half, and rows of
    128 ascending occupied ids of the shell at a fixed stride, as an update
    draws them): for each, a function that launches a library's kernel on an
    output filled with -1 once (the atomics take the max again on each call)
    and the plain version's result; beside them, the wrapper (``torch.full``
    and the kernel) on each input and the fill alone."""
    from nerfacc_tpu_torch.ops import _build
    from nerfacc_tpu_torch.ops import table_grad as tg

    rng = np.random.default_rng(1)
    ids, vals = cs.k3_inputs(rng)
    n_cells, n = 1 << 21, ids.size
    occupied = np.flatnonzero(cs.shell_binaries(128).reshape(-1))
    rows = -(-occupied.size // 128)
    occupied = np.concatenate([occupied, occupied[-1:].repeat(rows * 128 - occupied.size)]).reshape(rows, 128)
    pick = np.minimum(((np.arange(n // 256) + rng.random()) * (rows / (n // 256))).astype(np.int64), rows - 1)
    sysrow = np.concatenate([rng.integers(0, n_cells, n // 2), occupied[pick].reshape(-1)]).astype(np.int32)
    order = np.argsort(ids, kind="stable")
    inputs, aside = {}, {"torch.full of the output alone": lambda: torch.full((n_cells,), -1.0, device=dev)}
    for label, (i_np, v_np) in {
        "phase 5's draws": (ids, vals), "sorted": (ids[order], vals[order]), "sysrow-shaped": (sysrow, vals),
    }.items():
        i_t = torch.from_numpy(np.ascontiguousarray(i_np)).to(dev)
        v_t = torch.from_numpy(np.ascontiguousarray(v_np)).to(dev)
        out = torch.full((n_cells,), -1.0, device=dev)

        def run(lib, i_t=i_t, v_t=v_t, out=out):
            rc = lib.cell_max_launch(i_t.data_ptr(), v_t.data_ptr(), out.data_ptr(), n, n_cells,
                                     torch.cuda.current_stream().cuda_stream)
            _build.check(lib, rc, "cell_max_launch")
            return out

        inputs[label] = (run, tg.cell_max_plain(i_t, v_t, n_cells))
        aside[f"cell_max, the wrapper [{label}]"] = lambda i_t=i_t, v_t=v_t: tg.cell_max(i_t, v_t, n_cells)
    return inputs, {"cell_max_launch": tg._cell_max_lib().cell_max_launch.argtypes}, aside


def k2_run(dev):
    """K2 on phase 5's inputs: the same, and the output's zeroing beside."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    u = cs.shell_points(np.random.default_rng(1), cs.TRAIN_CAPACITY, dev)
    _, sorted_idx, perm, w, dout, n_rows = cs.fused_inputs(u, np.random.default_rng(2), dev)
    wq, dout = tg.quantize_u10(*w), dout.to(torch.bfloat16)

    def run(lib):
        return tg._launch(lib, "table_grad_u10_launch", (sorted_idx, perm, wq, dout), n_rows,
                          tg._INV_1023, span=tg.K2_TILE)

    argtypes = tg._table_grad_u10_lib().table_grad_u10_launch.argtypes
    want = tg.table_grad_u10_plain(sorted_idx, perm, wq, dout, n_rows)
    return {"": (run, want)}, {"table_grad_u10_launch": argtypes}, _zeros_aside(n_rows, dev)


def k4_run(dev):
    """K4 on phase 5's inputs in its four modes (w3 and w8, float32 and
    bf16), each with the output's zeroing."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    u = cs.shell_points(np.random.default_rng(1), cs.TRAIN_CAPACITY, dev)
    _, sorted_idx, perm, w3, dout, n_rows = cs.fused_inputs(u, np.random.default_rng(2), dev)
    w8 = tg.corner_weights(*w3).contiguous()
    inputs = {}
    for dtype in (torch.float32, torch.bfloat16):
        d, bf = dout.to(dtype), int(dtype == torch.bfloat16)
        w3_t, w8_t = [w.to(dtype) for w in w3], w8.to(dtype)
        label = "float32" if dtype == torch.float32 else "bf16"

        def run_w3(lib, w3_t=w3_t, d=d, bf=bf):
            return tg._launch(lib, "table_grad_w3_launch", (sorted_idx, perm, *w3_t, d), n_rows, bf,
                              span=tg.K4_TILE[d.dtype])

        def run_w8(lib, w8_t=w8_t, d=d, bf=bf):
            return tg._launch(lib, "table_grad_w8_launch", (sorted_idx, perm, w8_t, d), n_rows, bf,
                              span=tg.K4_TILE[d.dtype])

        inputs[f"w3 {label}"] = (run_w3, tg.table_grad_w3_plain(sorted_idx, perm, *w3_t, d, n_rows))
        inputs[f"w8 {label}"] = (run_w8, tg.table_grad_w8_plain(sorted_idx, perm, w8_t, d, n_rows))
    lib = tg._table_grad_lib()
    signatures = {name: getattr(lib, name).argtypes for name in ("table_grad_w3_launch", "table_grad_w8_launch")}
    return inputs, signatures, _zeros_aside(n_rows, dev)


def k6_run(dev):
    """The same for K6."""
    from nerfacc_tpu_torch.ops import table_grad as tg

    args, _, _ = cs.k6_inputs(cs.shell_points(np.random.default_rng(1), cs.TRAIN_CAPACITY, dev),
                              np.random.default_rng(2), dev)
    sorted_key, perm, xs, ys, zs, dout, n_rows, fetches, F, consts = args
    n, nf, jg = xs.shape[0], len(fetches), len(fetches[0].res)
    res = (ctypes.c_float * (nf * jg))(*[float(r) for f in fetches for r in f.res])
    j_lo = (ctypes.c_int * nf)(*[f.j_lo for f in fetches])
    key = (ctypes.c_int * nf)(*[f.key for f in fetches])

    def run(lib):
        pos = torch.empty((n, 4), dtype=torch.float32, device=dev)
        return tg._launch(lib, "table_grad_pos_launch", (sorted_key, perm, xs, ys, zs, pos, dout), n_rows,
                          n, nf, jg, F, tg.ROW_WIDTH // (8 * F), res, j_lo, key, span=None)

    argtypes = tg._table_grad_pos_lib().table_grad_pos_launch.argtypes
    return {"": (run, tg.table_grad_pos_plain(*args))}, {"table_grad_pos_launch": argtypes}, _zeros_aside(n_rows, dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernels", nargs="*", choices=sorted(VARIANTS), help="default: all")
    kernels = ap.parse_args(argv).kernels or sorted(VARIANTS)
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}", flush=True)
    runs = {"k1": k1_run, "k2": k2_run, "k3": k3_run, "k4": k4_run, "k6": k6_run}
    for kernel in kernels:
        inputs, signatures, aside = runs[kernel](dev)
        libs = build(kernel, Path("build/kernel_variants"))
        for (name, keeps, _), lib in zip(VARIANTS[kernel][1], libs.values()):
            for fn_name, argtypes in signatures.items():
                getattr(lib, fn_name).argtypes = argtypes
                getattr(lib, fn_name).restype = ctypes.c_int
            for label, (run, want) in inputs.items():
                if not keeps:
                    continue
                got = run(lib)
                if kernel in ("k1", "k3"):  # exact; K3 bit for bit
                    if kernel == "k3":
                        got, want = got.view(torch.int32), want.view(torch.int32)
                    err = int((got != want).sum())
                    agree = err == 0
                else:
                    err = float((got - want).abs().max())
                    agree = err <= 1e-5 * float(want.abs().max())
                if not agree:
                    cs.fail(f"{kernel} variant {name!r} disagrees with the plain version{label and ' on ' + label}: {err}")
        for label, (run, _) in inputs.items():
            times = {name: [] for name in libs}
            for _ in range(3):
                for name, lib in libs.items():
                    times[name].append(cs.time_ms(lambda: run(lib)))
            for name, ms in times.items():
                print(f"{kernel} variant {name}{label and ' [' + label + ']'}: {float(np.median(ms)):.4f} ms "
                      f"(rounds {', '.join(f'{t:.4f}' for t in ms)})", flush=True)
        del inputs
        for label, fn in aside.items():
            print(f"{kernel}: {label}: {cs.time_ms(fn):.4f} ms", flush=True)


if __name__ == "__main__":
    sys.exit(main())
