// Per-cell max of non-negative values, -1 where no value names the cell.
//
// Replaces the TPU kernel nerfacc_tpu/ops/table_grad.py:cell_max_sorted
// (kernel body _cell_place_kernel): out = full(-1).at[ids].max(vals), the
// occupancy grid's EMA max over the probed cells.  The TPU version sorts,
// scans for run maxima and places (max + 1) with one-hot matmuls, which
// rounds values near 1e-3 by up to ~6e-8.  Here one pass of atomicMax on the
// int32 bit patterns gives the exact maximum with no sort: non-negative
// floats order like their bits, and the output starts at the bits of -1.0f,
// which are negative as int32.  -0.0f (bits INT_MIN) is taken as +0.0f.  Ids
// outside [0, n_cells) are skipped.  The plain PyTorch version
// (nerfacc_tpu_torch/ops/table_grad.py:cell_max_plain) takes the same max of
// the same bits.
//
// What bounds it: the L2's atomic rate.  At the training shape (1,048,576
// draws into 2,097,152 cells) the bytes are 8 B a draw and 4 B a cell, 16.8
// MB, 0.0050 ms at 3.35 TB/s.  The wrapper's -1 fill (torch.full) takes
// 0.0037 ms and this kernel 0.0142 ms on uniform and shell ids, about 27% of
// the bound for the two, and 0.0094 ms on an update's rows of ascending
// occupied ids, which share sectors (H100 80GB HBM3 at 700 W,
// kernel_variants.py k3).  A warp's atomicMax on 32 scattered ids is 32 L2
// operations.  Loading four draws a thread with 16-byte loads leaves the
// scattered case as it is and slows the other (fewer lanes of a warp share a
// sector).  Two other designs measured slower on an update's draws: the fill
// and the atomics in one cooperative launch, across a grid-wide barrier; and
// the TPU kernel's plan, draws bucketed by window of cells in one pass and
// each window placed with shared-memory atomics in a second, whose passes
// cost more than the atomics they save.

#include <limits.h>
#include <stdint.h>

#include "common.cuh"

namespace {

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
  if (n <= 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  cell_max_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      ids, vals, reinterpret_cast<int*>(out), n, n_cells);
  return static_cast<int>(cudaGetLastError());
}
