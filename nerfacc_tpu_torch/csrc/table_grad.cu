// Table gradient of the fused hash encoder from w3 or w8 factors: kernel K4.
//
// Replaces the TPU kernel nerfacc_tpu/ops/table_grad.py:
//   table_grad_factors_sorted (_factor_kernel), wpack "w3" and "w8"  -> K4.
// (K2, the u10 mode of the same sum, has its own tile kernel in
// csrc/table_grad_u10.cu.)
// For each sample i with table row r_i, corner weights w_c(i) and output
// cotangent dout_i (16 features), it adds w_c(i) * dout_i[f] into
// out[r_i, c * 16 + f] for the 8 corners c = 4 dx + 2 dy + dz.  The weights
// arrive in one of two forms:
//   w3: the three fractions (wx, wy, wz), in bf16 or float32;
//   w8: the eight corner weights, in bf16 or float32.
// From w3 the corner weight is the float32 product (wx' * wy') * wz'.  With
// bf16 inputs each corner weight is rounded to bf16 and each product
// w_c * dout_f is rounded to bf16 before it is added in float32 -- the steps
// of the Pallas kernel, term for term.  In float32 the products and sums are
// float32.  The plain PyTorch versions (nerfacc_tpu_torch/ops/table_grad.py:
// table_grad_w3_plain, table_grad_w8_plain) do the same arithmetic; only the
// order of the float32 sums differs.  Built with --fmad=false.
//
// What bounds it: device memory.  At the training shape (2,097,152
// sample-levels, 131,072 rows), w3 in bf16 reads 42 B per sample (row,
// weights, 32 B of bf16 cotangent) and writes a 64 MiB table: 155 MB,
// 0.046 ms at 3.35 TB/s; the arithmetic (8 x 16 multiply-adds a sample) is
// far below the card's rate.  The TPU kernel built one-hot matrices for the
// MXU; here the samples come sorted by row (torch.sort, outside the kernel)
// and each warp reduces one contiguous span of them (csrc/sorted_rows.cuh):
// lane l holds columns 4l .. 4l + 3, that is corner l / 4 and features
// 4 (l % 4) .. + 3.  Adding every term with an unsorted atomicAdd would
// serialise on the densely indexed coarse level (4096 rows receive a quarter
// of all samples).  One launch covers all levels: row ids are unique across
// them.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "sorted_rows.cuh"

namespace {

constexpr int kF = 16;     // features per corner
constexpr int kRow = 128;  // 8 corners x 16 features

enum class Weights { kW3, kW8 };

// T is the type of dout and of the weights; the terms are rounded to bf16
// when T is bf16.
template <Weights kW, typename T>
struct FactorOp {
  struct Sample {
    int64_t p = 0;  // the sample's index in the unsorted inputs
    float x = 0.f, y = 0.f, z = 0.f;  // w3 weights
    __device__ Sample shfl(int j) const {
      Sample s;
      s.p = shfl64(p, j);
      if constexpr (kW == Weights::kW3) {
        s.x = __shfl_sync(kAllLanes, x, j);
        s.y = __shfl_sync(kAllLanes, y, j);
        s.z = __shfl_sync(kAllLanes, z, j);
      }
      return s;
    }
  };

  const int64_t* perm;
  const T* wx;
  const T* wy;
  const T* wz;
  const T* w8;
  const T* dout;
  float* out;
  int lane, c;
  bool hx, hy, hz;
  float acc[4];

  __device__ Sample load(int64_t i) const {
    Sample s;
    s.p = __ldg(perm + i);
    if constexpr (kW == Weights::kW3) {
      s.x = to_float(__ldg(wx + s.p));
      s.y = to_float(__ldg(wy + s.p));
      s.z = to_float(__ldg(wz + s.p));
    }
    return s;
  }

  __device__ void add(const Sample& s, int) {
    float w;
    if constexpr (kW == Weights::kW3) {
      w = (hx ? s.x : 1.f - s.x) * (hy ? s.y : 1.f - s.y);
      w = w * (hz ? s.z : 1.f - s.z);
    } else {
      w = to_float(__ldg(w8 + s.p * 8 + c));
    }
    float d[4];
    load4(dout + s.p * kF + (lane & 3) * 4, d);
    if constexpr (sizeof(T) == 2) {
      w = bf16_round(w);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += bf16_round(w * d[k]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] += w * d[k];
    }
  }

  __device__ void flush(int row, bool atomic) {
    flush4(out + static_cast<int64_t>(row) * kRow + lane * 4, acc, atomic);
  }
};

template <Weights kW, typename T>
__global__ void __launch_bounds__(256)
    table_grad_kernel(const int32_t* __restrict__ sorted_idx,
                      const int64_t* __restrict__ perm,
                      const T* __restrict__ wx, const T* __restrict__ wy,
                      const T* __restrict__ wz,
                      const T* __restrict__ w8, const T* __restrict__ dout,
                      float* __restrict__ out, int64_t n, int span) {
  FactorOp<kW, T> op;
  op.perm = perm;
  op.wx = wx;
  op.wy = wy;
  op.wz = wz;
  op.w8 = w8;
  op.dout = dout;
  op.out = out;
  op.lane = threadIdx.x & 31;
  op.c = op.lane >> 2;
  op.hx = (op.c >> 2) & 1;
  op.hy = (op.c >> 1) & 1;
  op.hz = op.c & 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) op.acc[k] = 0.f;
  sum_sorted_span(sorted_idx, n, span, op);
}

template <Weights kW, typename T>
int launch(const int32_t* sorted_idx, const int64_t* perm, const void* wx,
           const void* wy, const void* wz, const void* w8, const void* dout,
           float* out, long long n, int span, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = sorted_span_blocks(n, span);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  table_grad_kernel<kW, T><<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted_idx, perm, static_cast<const T*>(wx), static_cast<const T*>(wy),
      static_cast<const T*>(wz), static_cast<const T*>(w8),
      static_cast<const T*>(dout), out, n, span);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: wx, wy, wz and dout are bf16; else float32.
extern "C" int table_grad_w3_launch(const int32_t* sorted_idx,
                                    const int64_t* perm, const void* wx,
                                    const void* wy, const void* wz,
                                    const void* dout, float* out, long long n,
                                    int span, int bf16, void* stream) {
  if (bf16) {
    return launch<Weights::kW3, __nv_bfloat16>(sorted_idx, perm, wx, wy, wz,
                                               nullptr, dout, out, n, span,
                                               stream);
  }
  return launch<Weights::kW3, float>(sorted_idx, perm, wx, wy, wz, nullptr,
                                     dout, out, n, span, stream);
}

// bf16 != 0: w8 (N, 8) and dout are bf16; else float32.
extern "C" int table_grad_w8_launch(const int32_t* sorted_idx,
                                    const int64_t* perm, const void* w8,
                                    const void* dout, float* out, long long n,
                                    int span, int bf16, void* stream) {
  if (bf16) {
    return launch<Weights::kW8, __nv_bfloat16>(sorted_idx, perm, nullptr,
                                               nullptr, nullptr, w8, dout, out,
                                               n, span, stream);
  }
  return launch<Weights::kW8, float>(sorted_idx, perm, nullptr, nullptr,
                                     nullptr, w8, dout, out, n, span, stream);
}
