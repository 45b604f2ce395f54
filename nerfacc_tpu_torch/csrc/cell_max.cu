// Per-cell max of non-negative values, -1 where no value names the cell.
//
// Replaces the TPU kernel nerfacc_tpu/ops/table_grad.py:cell_max_sorted
// (kernel body _cell_place_kernel): out = full(-1).at[ids].max(vals), the
// occupancy grid's EMA max over the probed cells.  The TPU version sorts,
// scans for run maxima and places (max + 1) with one-hot matmuls, which
// rounds values near 1e-3 by up to ~6e-8.  Here one atomicMax a draw on the
// int32 bit patterns gives the exact maximum with no sort: non-negative
// floats order like their bits, and every cell starts at the bits of -1.0f,
// which are negative as int32.  -0.0f (bits INT_MIN) is taken as +0.0f.  Ids
// outside [0, n_cells) are skipped.  The plain PyTorch version
// (nerfacc_tpu_torch/ops/table_grad.py:cell_max_plain) takes the same max of
// the same bits.  The launch writes every cell: the -1 fill is part of it.
//
// What bounds it: device memory.  At the training shape (1,048,576 draws
// into 2,097,152 cells) the function reads 8 B a draw and writes 4 B a cell,
// 16.8 MB, 0.0050 ms at 3.35 TB/s; an unbounded level (2^20 draws into
// 2^23 cells) 42 MB, 0.0125 ms.  The atomics need the fill before them, and
// 2^20 atomics into scattered cells are L2 work that the bound does not
// count.
//
// Design: two kernels, the second launched as a programmatic dependent
// launch of the first.
//  1. fill_kernel: one wave of blocks writes -1.0f to every cell in 16-byte
//     stores, and at its start lets the next grid be scheduled.
//  2. cell_max_kernel: one wave of blocks over tiles of 1024 draws, eight
//     rows of 128.  A thread takes one column of four consecutive rows, so
//     a warp's lanes stay on consecutive draws (an update's ascending rows
//     share sectors) and an occupied row that the update draws at
//     neighbouring rows (it draws each ~3 times on the bench grid) meets
//     its repeats in the thread's own registers: equal ids are merged
//     there and send one atomicMax.  The first tile's loads are issued
//     while the fill runs; griddepcontrol.wait then waits for the fill's
//     grid (complete, its stores visible) before any atomic.
//
// Measured on one NVIDIA H100 80GB HBM3 at a 700.00 W power limit
// (kernel_variants.py k3; ms a call, the fill included, on update-shaped
// draws into 2^21 / 2^23 cells, bounds 0.0050 / 0.0125):
//   this design                                  0.0129 / 0.0233
//     its fill, its atomics (torch.profiler)     0.0031 + 0.0083 / 0.0096 + 0.0142
//     without merging a thread's repeated ids    0.0136 / 0.0237
//     without the dependent launch               0.0125 / 0.0238
//   the design before: torch.full, then one atomicMax a draw,
//     a block a 256 draws                        0.0140 / 0.0239
//     with four draws a thread                   0.0162 / 0.0284
//     the fill and the atomics in one cooperative launch
//                                                0.0156 / 0.0265
//     a block's draws merged in shared memory first
//                                                0.0341 / 0.0455
//   the draws partitioned by window of 8192 cells (a block-local counting
//     sort), each window placed with shared-memory atomics
//                                                0.0206 / 0.0309
//   windows in a 16-block cluster's distributed shared memory, each draw
//     sent to its cell's block by red.shared::cluster
//                                                0.0757 / 0.0797
// chip_smoke.py measures it on each path's own draws: one update (phase 6)
// 0.0119 ms against its 0.0050 bound, the capture's 4-level update (phase
// 19) 0.0269 against 0.0125.  Below half the bound because the atomics
// follow the fill and 2^19 of an update's draws are uniform, each an
// atomic to its own L2 sector; the partition that would remove those
// atomics costs two passes of dependent loads and block barriers more.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // each kernel's wave: 1024 threads an SM, so both fit at once
constexpr int kRow = 128;        // draws a row: the width of an update's sysrow rows
constexpr int kUnroll = 4;       // rows a thread: its draws in flight
constexpr int kTile = kThreads * kUnroll;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads) fill_kernel(int* __restrict__ out, int n_cells) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int m = static_cast<int>(0xBF800000u);  // -1.0f
  const int4 m4 = make_int4(m, m, m, m);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (long long i = first; i < n_cells / 4; i += stride) out4[i] = m4;
  for (long long i = n_cells / 4 * 4 + first; i < n_cells; i += stride) out[i] = m;
}

// Draw r * kRow + c of a tile is column c of row r; thread t takes column
// t % kRow of rows (t / kRow) * kUnroll, ... + kUnroll - 1.
__device__ __forceinline__ void load_tile(const int32_t* __restrict__ ids, const float* __restrict__ vals,
                                          long long t0, long long n, int (&id)[kUnroll], int (&bits)[kUnroll]) {
  const long long d0 = t0 + (threadIdx.x / kRow) * kUnroll * kRow + threadIdx.x % kRow;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long j = d0 + k * kRow;
    id[k] = j < n ? __ldg(ids + j) : -1;
    const int b = j < n ? __float_as_int(__ldg(vals + j)) : 0;
    bits[k] = b == INT_MIN ? 0 : b;  // -0.0f counts as +0.0f
  }
}

__global__ void __launch_bounds__(kThreads) cell_max_kernel(const int32_t* __restrict__ ids,
                                                            const float* __restrict__ vals,
                                                            int* __restrict__ out, long long n, int n_cells) {
  const long long stride = static_cast<long long>(gridDim.x) * kTile;
  long long t0 = static_cast<long long>(blockIdx.x) * kTile;
  int id[kUnroll], bits[kUnroll];
  load_tile(ids, vals, t0, n, id, bits);
  // The fill's grid has completed and its stores are visible after this.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  while (true) {
#pragma unroll
    for (int k = 1; k < kUnroll; ++k) {  // a repeat of the row above: one atomic for both
      if (id[k] == id[k - 1]) {
        bits[k] = max(bits[k], bits[k - 1]);
        id[k - 1] = -1;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (static_cast<unsigned>(id[k]) < static_cast<unsigned>(n_cells)) atomicMax(out + id[k], bits[k]);
    }
    t0 += stride;
    if (t0 >= n) break;
    load_tile(ids, vals, t0, n, id, bits);
  }
}

}  // namespace

// out: n_cells float32, 16-byte aligned; every cell is written.
extern "C" int cell_max_launch(const int32_t* ids, const float* vals, float* out, long long n, int n_cells,
                               void* stream) {
  if (n_cells <= 0 || n < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  static int sms[kMaxDevices] = {};
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long wave = static_cast<long long>(sms[dev]) * kBlocksPerSm;
  const auto s = static_cast<cudaStream_t>(stream);
  const long long fill_want = (n_cells / 4 + kThreads - 1) / kThreads;
  fill_kernel<<<static_cast<unsigned>(fill_want < 1 ? 1 : fill_want < wave ? fill_want : wave), kThreads, 0, s>>>(
      reinterpret_cast<int*>(out), n_cells);
  err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);

  const long long want = (n + kTile - 1) / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(want < wave ? want : wave));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, cell_max_kernel, ids, vals, reinterpret_cast<int*>(out), n, n_cells);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
