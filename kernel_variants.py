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
5's draws, on the same draws sorted by id, on ``sysrow``-shaped draws and on
those draws in level 1 of four levels, 2^23 cells; every variant writes
every cell, its fill included; the wrapper, the kernel with no draws (its
fill's share) and ``torch.full`` of the output are timed beside them, and
the wrapper's two kernels are profiled apart):

- ``kernel``: the source as it is: a one-wave fill, then one atomicMax a
  run of equal ids among a thread's four draws (one column of four rows of
  128), launched as a programmatic dependent launch of the fill.
- ``launch only``: both kernels return at once; ``fill only``: the atomics'
  kernel returns at once.
- ``no merging of a thread's repeated ids``: one atomicMax a draw.
- ``no programmatic dependent launch``: the atomics launched in stream
  order.
- ``one draw in flight a thread``; ``two blocks an SM``, ``eight blocks an
  SM``: other waves.
- ``partition``: the draws partitioned by window of 8192 cells (a
  block-local counting sort of each 4096-draw chunk, one count atomic a run
  of equal windows among a thread's eight draws), then one block a window
  placing them with shared-memory atomicMax and writing the window once;
  also with a count atomic a draw, with ``__match_any_sync`` merging a
  warp's counts, and with windows of 4096 cells.
- ``cluster windows``: the windows held in a 16-block cluster's distributed
  shared memory, each draw sent to the block that owns its cell with
  ``red.shared::cluster.max.s32``; also with clusters of 8, and with
  16,384 cells a block (more windows, each cluster reading every draw).
- ``atomics: a fill, then one atomicMax a draw``: the kernel this design
  replaced (``torch.full`` then one atomicMax a draw into device memory, a
  block a 256 draws), with a fill kernel of its own.
- ``atomics, four draws a thread``: the same with 16-byte loads.
- ``atomics, the fill in one cooperative launch``: the fill and the atomics
  in one kernel, across a grid-wide barrier.
- ``atomics, a block's draws merged in shared memory first``: a block merges
  a tile of 2048 draws by id, then sends one atomicMax an id.

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
# The K3 that the current design replaced: a fill of the output, then one
# atomicMax a draw into device memory.  The variants built on it start from
# this text.
K3_ATOMIC = r"""#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void fill_kernel(int* __restrict__ out_bits, int n_cells) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int m = __float_as_int(-1.0f);
  for (int64_t i = first; i < n_cells / 4; i += stride) reinterpret_cast<int4*>(out_bits)[i] = make_int4(m, m, m, m);
  for (int64_t i = n_cells / 4 * 4 + first; i < n_cells; i += stride) out_bits[i] = m;
}

__global__ void cell_max_kernel(const int32_t* __restrict__ ids,
                                const float* __restrict__ vals,
                                int* __restrict__ out_bits, int64_t n,
                                int n_cells) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int id = __ldg(ids + i);
    if (id < 0 || id >= n_cells) continue;
    int bits = __float_as_int(__ldg(vals + i));
    if (bits == INT_MIN) bits = 0;  // -0.0f
    atomicMax(out_bits + id, bits);
  }
}

}  // namespace

extern "C" int cell_max_launch(const int32_t* ids, const float* vals,
                               float* out, long long n, int n_cells,
                               void* stream) {
  const int threads = 256;
  fill_kernel<<<1024, threads, 0, static_cast<cudaStream_t>(stream)>>>(reinterpret_cast<int*>(out), n_cells);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  cell_max_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, vals, reinterpret_cast<int*>(out), n, n_cells);
  return static_cast<int>(cudaGetLastError());
}
"""
# The draws partitioned by window of cells (a block-local counting sort of
# each 4096-draw chunk), then one block a window placing them with
# shared-memory atomicMax and writing the window once (measured slower, not
# kept).
K3_PARTITION = r"""#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kChunk = 4096;                       // draws a bucket_kernel block sorts
constexpr int kPerThread = kChunk / kThreads;      // 8: two 16-byte loads of ids and of values
constexpr int kWindow = 8192;                      // cells a window, where kMaxBuckets allow
constexpr int kMaxBuckets = 4096;                  // windows at most
constexpr int kSmemCells = 53248;                  // cells a place_kernel block holds at once (with
                                                   // its offsets, within 227 KB)
constexpr int kGroup = 1024;                       // chunks whose segments a block scans at once
constexpr int kUnroll = 4;                         // draws in flight a thread in place_kernel
constexpr int kMaxDevices = 64;
constexpr int kNegOneBits = static_cast<int>(0xBF800000u);  // -1.0f

struct Plan {
  int window;        // W cells a window, a multiple of 8
  int windows;       // nb
  int part;          // cells a place_kernel block holds at once
  long long chunks;  // bucket_kernel blocks
};

Plan plan(long long n, int n_cells) {
  // Windows of kWindow cells, wider where more than kMaxBuckets would take.
  const long long least = (n_cells + kMaxBuckets - 1) / kMaxBuckets;
  const long long w = (least > kWindow ? least + 7 : kWindow) / 8 * 8;
  Plan p;
  p.window = static_cast<int>(w);
  p.windows = static_cast<int>((n_cells + w - 1) / w);
  p.part = static_cast<int>(w < kSmemCells ? w : kSmemCells);
  p.chunks = (n + kChunk - 1) / kChunk;
  return p;
}

// In-place exclusive scan of a[0, m) by the whole block; returns the total.
// sums: 33 ints of shared memory.
__device__ int block_scan(int* a, int m, int* sums) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (m + kThreads - 1) / kThreads;
  const int lo = min(tid * per, m), hi = min(lo + per, m);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += a[i];
  int incl = own;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kThreads / 32 ? sums[lane] : 0;
    int wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += v;
    }
    if (lane < kThreads / 32) sums[lane] = wi - w;
    if (lane == 31) sums[32] = wi;
  }
  __syncthreads();
  int run = sums[warp] + incl - own;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  const int total = sums[32];
  __syncthreads();
  return total;
}

// Pass 1.  Chunk c's draws, sorted by window, go to sorted[c * kChunk ...]
// as (id, value bits); offsets[c * (nb + 1) + b] is where window b starts
// in the chunk, and offsets[c * (nb + 1) + nb] the chunk's count of ids in
// [0, n_cells).
__global__ void __launch_bounds__(kThreads) bucket_kernel(const int32_t* __restrict__ ids,
                                                          const float* __restrict__ vals, int2* __restrict__ sorted,
                                                          int* __restrict__ offsets, long long n, int n_cells,
                                                          int window, int nb, bool vec) {
  extern __shared__ int4 smem4[];
  int2* stage = reinterpret_cast<int2*>(smem4);              // kChunk draws
  int* counts = reinterpret_cast<int*>(stage + kChunk);      // nb + 1
  int* sums = counts + ((nb + 4) / 4 * 4);                   // 33
  const int tid = threadIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * kChunk;
  for (int b = tid; b <= nb; b += kThreads) counts[b] = 0;

  int id[kPerThread], bits[kPerThread];
  const long long d0 = c0 + tid * kPerThread;
  if (vec && c0 + kChunk <= n) {
    const int4* i4 = reinterpret_cast<const int4*>(ids + d0);
    const int4* v4 = reinterpret_cast<const int4*>(vals + d0);
#pragma unroll
    for (int h = 0; h < kPerThread / 4; ++h) {
      const int4 a = __ldg(i4 + h), v = __ldg(v4 + h);
      id[4 * h] = a.x, id[4 * h + 1] = a.y, id[4 * h + 2] = a.z, id[4 * h + 3] = a.w;
      bits[4 * h] = v.x, bits[4 * h + 1] = v.y, bits[4 * h + 2] = v.z, bits[4 * h + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const bool in = d0 + k < n;
      id[k] = in ? __ldg(ids + d0 + k) : -1;
      bits[k] = in ? __float_as_int(__ldg(vals + d0 + k)) : 0;
    }
  }
  __syncthreads();  // counts zeroed

  // Window of each draw (nb for a skipped one) and its place within the
  // chunk's share of that window: a run of equal windows among a thread's
  // consecutive draws (an update's ascending rows) takes one atomicAdd.
  int bucket[kPerThread], pos[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const bool ok = static_cast<unsigned>(id[k]) < static_cast<unsigned>(n_cells);
    bucket[k] = ok ? static_cast<int>(static_cast<unsigned>(id[k]) / static_cast<unsigned>(window)) : nb;
    if (bits[k] == INT_MIN) bits[k] = 0;  // -0.0f
    pos[k] = k > 0 && bucket[k] == bucket[k - 1] ? pos[k - 1] + 1 : 0;  // rank within the run
  }
  int base = 0;
#pragma unroll
  for (int k = kPerThread - 1; k >= 0; --k) {
    if (k == kPerThread - 1 || bucket[k] != bucket[k + (k < kPerThread - 1)]) {
      base = atomicAdd(counts + bucket[k], pos[k] + 1);  // the run ends at k
    }
    pos[k] += base;
  }
  __syncthreads();
  block_scan(counts, nb + 1, sums);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (bucket[k] < nb) stage[counts[bucket[k]] + pos[k]] = make_int2(id[k], bits[k]);
  }
  int* row = offsets + static_cast<long long>(blockIdx.x) * (nb + 1);
  for (int b = tid; b <= nb; b += kThreads) row[b] = counts[b];
  __syncthreads();
  const int kept = counts[nb];
  int4* dst = reinterpret_cast<int4*>(sorted + c0);
  for (int i = tid; 2 * i < kept; i += kThreads) dst[i] = smem4[i];
}

// Pass 2: block b places window b's draws and writes its cells.
__global__ void __launch_bounds__(kThreads) place_kernel(const int2* __restrict__ sorted,
                                                         const int* __restrict__ offsets, int* __restrict__ out,
                                                         long long chunks, int n_cells, int window, int nb,
                                                         int part) {
  extern __shared__ int4 smem4[];
  int* cells = reinterpret_cast<int*>(smem4);  // part cells
  int* start = cells + part;                   // kGroup
  int* prefix = start + kGroup;                // kGroup
  int* sums = prefix + kGroup;                 // 33
  const int tid = threadIdx.x, b = blockIdx.x;
  const long long wlo = static_cast<long long>(b) * window;
  const long long whi = min(wlo + window, static_cast<long long>(n_cells));
  const int4 neg = make_int4(kNegOneBits, kNegOneBits, kNegOneBits, kNegOneBits);
  for (long long lo = wlo; lo < whi; lo += part) {
    const int len = static_cast<int>(min(static_cast<long long>(part), whi - lo));
    for (int i = tid; 4 * i < len; i += kThreads) smem4[i] = neg;
    for (long long g0 = 0; g0 < chunks; g0 += kGroup) {
      const int g = static_cast<int>(min(static_cast<long long>(kGroup), chunks - g0));
      __syncthreads();  // cells set; the last group's offsets read
      for (int j = tid; j < g; j += kThreads) {
        const int* row = offsets + (g0 + j) * (nb + 1) + b;
        start[j] = __ldg(row);
        prefix[j] = __ldg(row + 1) - start[j];
      }
      __syncthreads();
      const int total = block_scan(prefix, g, sums);
      for (int t0 = tid; t0 < total; t0 += kUnroll * kThreads) {
        int2 d[kUnroll];
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const int t = t0 + k * kThreads;
          d[k] = make_int2(-1, 0);
          if (t < total) {
            int j = 0, hi = g;  // the last segment that starts at or before t
            while (hi - j > 1) {
              const int mid = (j + hi) >> 1;
              if (prefix[mid] <= t) j = mid; else hi = mid;
            }
            d[k] = __ldg(sorted + (g0 + j) * kChunk + start[j] + (t - prefix[j]));
          }
        }
#pragma unroll
        for (int k = 0; k < kUnroll; ++k) {
          const unsigned off = static_cast<unsigned>(d[k].x) - static_cast<unsigned>(lo);
          if (t0 + k * kThreads < total && off < static_cast<unsigned>(len)) atomicMax(cells + off, d[k].y);
        }
      }
    }
    __syncthreads();  // every draw placed
    int4* dst = reinterpret_cast<int4*>(out + lo);
    for (int i = tid; 4 * i < len; i += kThreads) {
      if (4 * i + 4 <= len) {
        dst[i] = smem4[i];
      } else {
        for (int k = 4 * i; k < len; ++k) out[lo + k] = cells[k];
      }
    }
    __syncthreads();  // cells written out before the next part sets them
  }
}

}  // namespace

// The scratch cell_max_launch needs: the sorted draws and the offsets.
extern "C" long long cell_max_scratch_bytes(long long n, int n_cells) {
  if (n_cells <= 0 || n < 0) return 0;
  const Plan p = plan(n, n_cells);
  return p.chunks * kChunk * static_cast<long long>(sizeof(int2)) +
         p.chunks * (p.windows + 1) * static_cast<long long>(sizeof(int));
}

// out: n_cells float32; scratch: cell_max_scratch_bytes(n, n_cells) bytes;
// both 16-byte aligned.  Every cell of out is written.
extern "C" int cell_max_launch(const int32_t* ids, const float* vals, float* out, long long n, int n_cells,
                               void* scratch, void* stream) {
  if (n_cells <= 0 || n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan p = plan(n, n_cells);
  if (p.chunks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bucket_smem = kChunk * sizeof(int2) + ((p.windows + 4) / 4 * 4 + 33) * sizeof(int);
  const size_t place_smem = (static_cast<size_t>(p.part) + 2 * kGroup + 33) * sizeof(int);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static bool configured[kMaxDevices] = {};
  if (!configured[dev]) {
    const int most_bucket = static_cast<int>(kChunk * sizeof(int2) + (kMaxBuckets + 4 + 33) * sizeof(int));
    const int most_place = static_cast<int>((kSmemCells + 2 * kGroup + 33) * sizeof(int));
    err = cudaFuncSetAttribute(bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most_bucket);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(place_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most_place);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sorted = static_cast<int2*>(scratch);
  int* offsets = reinterpret_cast<int*>(sorted + p.chunks * kChunk);
  if (p.chunks > 0) {
    const bool vec = reinterpret_cast<uintptr_t>(ids) % 16 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
    bucket_kernel<<<static_cast<unsigned>(p.chunks), kThreads, bucket_smem, s>>>(
        ids, vals, sorted, offsets, n, n_cells, p.window, p.windows, vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  place_kernel<<<static_cast<unsigned>(p.windows), kThreads, place_smem, s>>>(
      sorted, offsets, reinterpret_cast<int*>(out), p.chunks, n_cells, p.window, p.windows, p.part);
  return static_cast<int>(cudaGetLastError());
}
"""
# Windows of cells held in a 16-block cluster's distributed shared memory,
# each draw sent to the block that owns its cell with
# red.shared::cluster.max.s32 (measured slower, not kept).
K3_DSMEM = r"""#include <cooperative_groups.h>
#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kClusterLog2 = 4;        // 16 blocks a cluster (a non-portable size)
constexpr int kMaxBlockCells = 57344;  // 224 KB of shared memory a block
constexpr int kUnroll = 4;             // quads of draws in flight a thread
constexpr int kMaxDevices = 64;
constexpr int kNegOneBits = static_cast<int>(0xBF800000u);  // -1.0f

// Sends one draw to the block of the cluster that owns its cell, if the
// cell lies in the window [wbase, wbase + wlen).
__device__ __forceinline__ void place(int id, float v, uint32_t wbase, uint32_t wlen, uint32_t window) {
  const uint32_t off = static_cast<uint32_t>(id) - wbase;  // ids below wbase wrap past wlen
  if (off >= wlen) return;
  int bits = __float_as_int(v);
  if (bits == INT_MIN) bits = 0;  // -0.0f
  const uint32_t owner = (off >> 3) & ((1u << kClusterLog2) - 1);
  const uint32_t local = ((off >> (3 + kClusterLog2)) << 3) | (off & 7);
  uint32_t addr;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(addr) : "r"(window + 4 * local), "r"(owner));
  asm volatile("red.shared::cluster.max.s32 [%0], %1;" ::"r"(addr), "r"(bits) : "memory");
}

// One cluster a window of 16 * block_cells cells; vec: ids and vals are
// 16-byte aligned.
__global__ void __launch_bounds__(kThreads, 1)
    cell_max_kernel(const int32_t* __restrict__ ids, const float* __restrict__ vals, int* __restrict__ out,
                    long long n, int n_cells, int block_cells, bool vec) {
  extern __shared__ int4 cells[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int rank = static_cast<int>(cluster.block_rank());
  const long long wbase = static_cast<long long>(blockIdx.x >> kClusterLog2) * block_cells << kClusterLog2;
  const uint32_t wlen =
      static_cast<uint32_t>(min(static_cast<long long>(block_cells) << kClusterLog2, n_cells - wbase));
  const uint32_t window = static_cast<uint32_t>(__cvta_generic_to_shared(cells));

  const int4 neg = make_int4(kNegOneBits, kNegOneBits, kNegOneBits, kNegOneBits);
  for (int i = tid; i < block_cells / 4; i += kThreads) cells[i] = neg;
  cluster.sync();  // every block's cells at -1 before any draw lands

  // The cluster's threads stride over the draws together.
  const long long first = static_cast<long long>(rank) * kThreads + tid;
  const long long stride = static_cast<long long>(kThreads) << kClusterLog2;
  const uint32_t base = static_cast<uint32_t>(wbase);
  long long tail = first;
  if (vec) {
    const long long quads = n >> 2;
    const int4* ids4 = reinterpret_cast<const int4*>(ids);
    const float4* vals4 = reinterpret_cast<const float4*>(vals);
    long long q = first;
    for (; q + (kUnroll - 1) * stride < quads; q += kUnroll * stride) {
      int4 a[kUnroll];
      float4 v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        a[k] = __ldg(ids4 + q + k * stride);
        v[k] = __ldg(vals4 + q + k * stride);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        place(a[k].x, v[k].x, base, wlen, window);
        place(a[k].y, v[k].y, base, wlen, window);
        place(a[k].z, v[k].z, base, wlen, window);
        place(a[k].w, v[k].w, base, wlen, window);
      }
    }
    for (; q < quads; q += stride) {
      const int4 a = __ldg(ids4 + q);
      const float4 v = __ldg(vals4 + q);
      place(a.x, v.x, base, wlen, window);
      place(a.y, v.y, base, wlen, window);
      place(a.z, v.z, base, wlen, window);
      place(a.w, v.w, base, wlen, window);
    }
    tail = (quads << 2) + first;
  }
  for (long long i = tail; i < n; i += stride) place(__ldg(ids + i), __ldg(vals + i), base, wlen, window);
  cluster.sync();  // every draw placed; no block reads another's cells after this

  // Block `rank` owns the window's sectors rank, rank + 16, ...: two
  // 16-byte halves a sector, each written whole where it lies below n_cells.
  const int* own = reinterpret_cast<const int*>(cells);
  for (int i = tid; i < block_cells / 4; i += kThreads) {
    const long long cell = wbase + (static_cast<long long>(i >> 1) << (3 + kClusterLog2)) + rank * 8 + (i & 1) * 4;
    if (cell + 4 <= n_cells) {
      *reinterpret_cast<int4*>(out + cell) = cells[i];
    } else {
      for (int k = 0; k < 4 && cell + k < n_cells; ++k) out[cell + k] = own[4 * i + k];
    }
  }
}

}  // namespace

// out: n_cells float32, 16-byte aligned; every cell is written.
extern "C" int cell_max_launch(const int32_t* ids, const float* vals, float* out, long long n, int n_cells,
                               void* stream) {
  if (n_cells <= 0 || n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long cluster = 1LL << kClusterLog2;
  const long long windows = (n_cells + cluster * kMaxBlockCells - 1) / (cluster * kMaxBlockCells);
  // Equal windows, each block a whole number of 8-cell sectors.
  const long long per_block = (n_cells + windows * cluster - 1) / (windows * cluster);
  const int block_cells = static_cast<int>((per_block + 7) / 8 * 8);

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static bool configured[kMaxDevices] = {};
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(cell_max_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(cell_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxBlockCells * static_cast<int>(sizeof(int)));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(windows * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(block_cells) * sizeof(int);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = reinterpret_cast<uintptr_t>(ids) % 16 == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  err = cudaLaunchKernelEx(&cfg, cell_max_kernel, ids, vals, reinterpret_cast<int*>(out), n, n_cells, block_cells,
                           vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
"""
K3_DSMEM_CLUSTER = "constexpr int kClusterLog2 = 4;"
K3_DSMEM_BLOCK_CELLS = "constexpr int kMaxBlockCells = 57344;"
K3_FILL = "  fill_kernel<<<1024, threads, 0, static_cast<cudaStream_t>(stream)>>>(reinterpret_cast<int*>(out), n_cells);\n"
K3_LAUNCH = (
    "  cell_max_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
    "      ids, vals, reinterpret_cast<int*>(out), n, n_cells);\n"
)
K3_NAMESPACE_END = "}  // namespace\n"
K3_RUNS = (
    "  int base = 0;\n"
    "#pragma unroll\n"
    "  for (int k = kPerThread - 1; k >= 0; --k) {\n"
    "    if (k == kPerThread - 1 || bucket[k] != bucket[k + (k < kPerThread - 1)]) {\n"
    "      base = atomicAdd(counts + bucket[k], pos[k] + 1);  // the run ends at k\n"
    "    }\n"
    "    pos[k] += base;\n"
    "  }\n"
)
K3_EACH = (
    "#pragma unroll\n"
    "  for (int k = 0; k < kPerThread; ++k) pos[k] = atomicAdd(counts + bucket[k], 1);\n"
)
K3_MATCH = (
    "  const int lane = tid & 31;\n"
    "  const unsigned lt = (1u << lane) - 1;\n"
    "#pragma unroll\n"
    "  for (int k = 0; k < kPerThread; ++k) {\n"
    "    const unsigned peers = __match_any_sync(0xffffffffu, bucket[k]);\n"
    "    const int leader = __ffs(peers) - 1;\n"
    "    int base = 0;\n"
    "    if (lane == leader) base = atomicAdd(counts + bucket[k], __popc(peers));\n"
    "    pos[k] = __shfl_sync(0xffffffffu, base, leader) + __popc(peers & lt);\n"
    "  }\n"
)
K3_WINDOW = "constexpr int kWindow = 8192;"
K3_FILL_START = '  asm volatile("griddepcontrol.launch_dependents;");\n'
K3_ATOMICS_START = "  int id[kUnroll], bits[kUnroll];\n"
K3_MERGE_ROWS = (
    "#pragma unroll\n"
    "    for (int k = 1; k < kUnroll; ++k) {  // a repeat of the row above: one atomic for both\n"
    "      if (id[k] == id[k - 1]) {\n"
    "        bits[k] = max(bits[k], bits[k - 1]);\n"
    "        id[k - 1] = -1;\n"
    "      }\n"
    "    }\n"
)
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


# A block merges a tile of 2048 draws in shared memory (slots
# indexed by id mod 4096, linear probing; ascending ids keep ascending
# slots, so the flush keeps their sectors shared), then sends one atomicMax
# a distinct id to device memory.
K3_MERGE = """constexpr int kMergeTile = 2048;
constexpr int kMergeSlots = 4096;

__global__ void __launch_bounds__(512) merge_kernel(const int32_t* __restrict__ ids, const float* __restrict__ vals,
                                                    int* __restrict__ out_bits, int64_t n, int n_cells) {
  __shared__ int key[kMergeSlots];
  __shared__ int best[kMergeSlots];
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kMergeTile; t0 < n;
       t0 += static_cast<int64_t>(gridDim.x) * kMergeTile) {
    for (int s = threadIdx.x; s < kMergeSlots; s += blockDim.x) {
      key[s] = -1;
      best[s] = INT_MIN;
    }
    __syncthreads();
    const int64_t t1 = t0 + kMergeTile < n ? t0 + kMergeTile : n;
    for (int64_t i = t0 + threadIdx.x; i < t1; i += blockDim.x) {
      const int id = __ldg(ids + i);
      if (id < 0 || id >= n_cells) continue;
      int bits = __float_as_int(__ldg(vals + i));
      if (bits == INT_MIN) bits = 0;
      for (int s = id & (kMergeSlots - 1);; s = (s + 1) & (kMergeSlots - 1)) {
        const int k = atomicCAS(&key[s], -1, id);
        if (k == -1 || k == id) {
          atomicMax(&best[s], bits);
          break;
        }
      }
    }
    __syncthreads();
    for (int s = threadIdx.x; s < kMergeSlots; s += blockDim.x) {
      if (key[s] >= 0) atomicMax(out_bits + key[s], best[s]);
    }
    __syncthreads();
  }
}

"""
K3_MERGE_LAUNCH = (
    "  merge_kernel<<<static_cast<int>((n + 2047) / 2048 < 4096 ? (n + 2047) / 2048 : 4096), 512, 0,\n"
    "                 static_cast<cudaStream_t>(stream)>>>(ids, vals, reinterpret_cast<int*>(out), n, n_cells);\n"
)


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
        ("launch only", False, (
            (K3_FILL_START, "  if (n_cells > 0) return;\n" + K3_FILL_START),
            (K3_ATOMICS_START, "  if (n_cells > 0) return;\n" + K3_ATOMICS_START),
        )),
        ("fill only", False, ((K3_ATOMICS_START, "  if (n_cells > 0) return;\n" + K3_ATOMICS_START),)),
        ("no merging of a thread's repeated ids", True, ((K3_MERGE_ROWS, ""),)),
        ("no programmatic dependent launch", True, (("  cfg.numAttrs = 1;\n", "  cfg.numAttrs = 0;\n"),)),
        ("one draw in flight a thread", True, (("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;"),)),
        ("two blocks an SM", True, (("constexpr int kBlocksPerSm = 4;", "constexpr int kBlocksPerSm = 2;"),)),
        ("eight blocks an SM", True, (("constexpr int kBlocksPerSm = 4;", "constexpr int kBlocksPerSm = 8;"),)),
        ("partition: draws sorted by window, each window placed in shared memory", True, ((None, K3_PARTITION),)),
        ("partition, a count atomic a draw", True, ((None, K3_PARTITION), (K3_RUNS, K3_EACH))),
        ("partition, counts merged across a warp", True, ((None, K3_PARTITION), (K3_RUNS, K3_MATCH))),
        ("partition, windows of 4096 cells", True, (
            (None, K3_PARTITION), (K3_WINDOW, "constexpr int kWindow = 4096;"),
        )),
        ("cluster windows: cells in 16 blocks' distributed shared memory", True, ((None, K3_DSMEM),)),
        ("cluster windows, clusters of 8", True, (
            (None, K3_DSMEM), (K3_DSMEM_CLUSTER, "constexpr int kClusterLog2 = 3;"),
        )),
        ("cluster windows, 16,384 cells a block", True, (
            (None, K3_DSMEM), (K3_DSMEM_BLOCK_CELLS, "constexpr int kMaxBlockCells = 16384;"),
        )),
        ("atomics: a fill, then one atomicMax a draw", True, ((None, K3_ATOMIC),)),
        ("atomics, four draws a thread", True, (
            (None, K3_ATOMIC), (K3_NAMESPACE_END, K3_FOUR + K3_NAMESPACE_END), (K3_LAUNCH, K3_FOUR_LAUNCH),
        )),
        ("atomics, the fill in one cooperative launch", True, (
            (None, K3_ATOMIC), ('#include "common.cuh"\n', '#include <cooperative_groups.h>\n\n#include "common.cuh"\n'),
            (K3_NAMESPACE_END, K3_COOP + K3_NAMESPACE_END), (K3_FILL, ""), (K3_LAUNCH, K3_COOP_LAUNCH),
        )),
        ("atomics, a block's draws merged in shared memory first", True, (
            (None, K3_ATOMIC), (K3_NAMESPACE_END, K3_MERGE + K3_NAMESPACE_END), (K3_LAUNCH, K3_MERGE_LAUNCH),
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
            if old is None:  # the whole source replaced
                text = new
                continue
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
    sorted by id, on ``sysrow``-shaped draws (a uniform half, and rows of
    128 ascending occupied ids of the shell at a fixed stride, as an update
    draws them) and on those draws moved into level 1 of four levels (2^23
    cells, the unbounded and capture updates' output): for each, a function
    that launches a library's kernel (which writes every cell) and the plain
    version's result; beside them, the wrapper on each input, the kernel with
    no draws (its fill's share) and ``torch.full`` of the output."""
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
    inputs, aside, scratches = {}, {}, {}  # a variant's scratch, made outside the timed calls
    for label, (i_np, v_np, cells) in {
        "phase 5's draws": (ids, vals, n_cells), "sorted": (ids[order], vals[order], n_cells),
        "sysrow-shaped": (sysrow, vals, n_cells), "sysrow-shaped, 4 levels": (sysrow + n_cells, vals, 4 * n_cells),
    }.items():
        i_t = torch.from_numpy(np.ascontiguousarray(i_np)).to(dev)
        v_t = torch.from_numpy(np.ascontiguousarray(v_np)).to(dev)
        out = torch.empty((cells,), device=dev)

        def run(lib, i_t=i_t, v_t=v_t, out=out, cells=cells):
            args = [i_t.data_ptr(), v_t.data_ptr(), out.data_ptr(), n, cells]
            if hasattr(lib, "cell_max_scratch_bytes"):  # the partitioned design takes scratch
                key = (id(lib), cells)
                if key not in scratches:
                    lib.cell_max_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int]
                    lib.cell_max_scratch_bytes.restype = ctypes.c_longlong
                    lib.cell_max_launch.argtypes = list(lib.cell_max_launch.argtypes[:5]) + [ctypes.c_void_p] * 2
                    scratches[key] = torch.empty((lib.cell_max_scratch_bytes(n, cells),), dtype=torch.uint8,
                                                 device=dev)
                args.append(scratches[key].data_ptr())
            rc = lib.cell_max_launch(*args, torch.cuda.current_stream().cuda_stream)
            _build.check(lib, rc, "cell_max_launch")
            return out

        inputs[label] = (run, tg.cell_max_plain(i_t, v_t, cells))
        aside[f"cell_max, the wrapper [{label}]"] = lambda i_t=i_t, v_t=v_t, c=cells: tg.cell_max(i_t, v_t, c)
        # The wrapper's two kernels apart, under torch.profiler: 10 calls.
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                tg.cell_max(i_t, v_t, cells)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            name = next((k for k in ("fill_kernel", "cell_max_kernel", "bucket_kernel", "place_kernel") if k in e.key), None)
            if name:
                print(f"k3: {name} [{label}]: {e.device_time_total / max(e.count, 1) / 1e3:.4f} ms "
                      f"a call (torch.profiler, {e.count} calls)", flush=True)
    none_i, none_v = torch.empty(0, dtype=torch.int32, device=dev), torch.empty(0, device=dev)
    for cells in (n_cells, 4 * n_cells):
        aside[f"cell_max with no draws (the fill's share) [{cells} cells]"] = (
            lambda c=cells: tg.cell_max(none_i, none_v, c))
        aside[f"torch.full of the output alone [{cells} cells]"] = lambda c=cells: torch.full((c,), -1.0, device=dev)
    lib = tg._cell_max_lib()
    signatures = {"cell_max_launch": lib.cell_max_launch.argtypes}
    return inputs, signatures, aside


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
