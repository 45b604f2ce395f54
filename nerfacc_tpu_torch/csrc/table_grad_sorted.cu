// Segment sum of a materialised cotangent: per-row sums of (N, 128) rows.
//
// Replaces the TPU kernel nerfacc_tpu/ops/table_grad.py:table_grad_sorted
// (kernel body _tgrad_kernel) -> K5, the table gradient of the fused
// encoder's table_grad="pallas" route: out[r] = sum over samples i with row
// r_i = r of dg[i], float32 sums of the bf16 or float32 rows.  The TPU kernel
// builds a one-hot matrix per 128 samples and reduces it on the MXU over a
// worklist of row windows; here the rows come sorted (torch.sort, outside the
// kernel) with the permutation that sorted them, and each warp reduces one
// contiguous span of sorted samples (csrc/sorted_rows.cuh): lane l adds
// columns 4l .. 4l + 3 of each sample's row, read through the permutation.
// The plain PyTorch version (nerfacc_tpu_torch/ops/table_grad.py:
// table_grad_sorted_plain) adds the same values; only the order of the
// float32 sums differs.
//
// What bounds it: device memory.  At the training shape (2,097,152
// sample-levels, 131,072 rows, bf16) it must read 256 B of cotangent and a
// 4 B row per sample and write a 64 MiB table: 612 MB, 0.18 ms at
// 3.35 TB/s.  Each sample's 256 B row is read whole by one warp (8 B a
// lane), so the gather through the permutation is coalesced per sample.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "sorted_rows.cuh"

namespace {

constexpr int kRow = 128;

template <typename T>
struct SegmentOp {
  struct Sample {
    int64_t p = 0;
    __device__ Sample shfl(int j) const {
      Sample s;
      s.p = shfl64(p, j);
      return s;
    }
  };

  const int64_t* perm;
  const T* dg;
  float* out;
  int lane;
  float acc[4];

  __device__ Sample load(int64_t i) const {
    Sample s;
    s.p = __ldg(perm + i);
    return s;
  }

  __device__ void add(const Sample& s, int) {
    float d[4];
    load4(dg + s.p * kRow + lane * 4, d);
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += d[k];
  }

  __device__ void flush(int row, bool atomic) {
    flush4(out + static_cast<int64_t>(row) * kRow + lane * 4, acc, atomic);
  }
};

template <typename T>
__global__ void __launch_bounds__(256)
    table_grad_sorted_kernel(const int32_t* __restrict__ sorted_idx,
                             const int64_t* __restrict__ perm,
                             const T* __restrict__ dg, float* __restrict__ out,
                             int64_t n, int span) {
  SegmentOp<T> op;
  op.perm = perm;
  op.dg = dg;
  op.out = out;
  op.lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 4; ++k) op.acc[k] = 0.f;
  sum_sorted_span(sorted_idx, n, span, op);
}

template <typename T>
int launch(const int32_t* sorted_idx, const int64_t* perm, const void* dg,
           float* out, long long n, int span, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = sorted_span_blocks(n, span);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  table_grad_sorted_kernel<T><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted_idx, perm, static_cast<const T*>(dg), out, n, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: dg is bf16; else float32.
extern "C" int table_grad_sorted_launch(const int32_t* sorted_idx,
                                        const int64_t* perm, const void* dg,
                                        float* out, long long n, int span,
                                        int bf16, void* stream) {
  if (bf16) {
    return launch<__nv_bfloat16>(sorted_idx, perm, dg, out, n, span, stream);
  }
  return launch<float>(sorted_idx, perm, dg, out, n, span, stream);
}
