// Table gradient of the fused hash encoder: per-row sums of rank-1 cotangents.
//
// Replaces the TPU kernels nerfacc_tpu/ops/table_grad.py:
//   table_grad_factors_sorted_u10 (kernel body _factor_kernel_u10)  -> K2,
//   table_grad_factors_sorted with wpack="w3" (_factor_kernel)       -> K4-w3.
// For each sample i with table row r_i, fractional cell weights
// (wx, wy, wz)_i and output cotangent dout_i (16 features), it adds
// w_c(i) * dout_i[f] into out[r_i, c * 16 + f] for the 8 corners
// c = 4 dx + 2 dy + dz, with w_c the product (wx' * wy') * wz'.
//   u10 (bf16 compute): the weights arrive as 10-bit fixed point in one
//     int32 and are dequantised as q * (1/1023), their complements as
//     fma(-q, 1/1023, 1) (XLA contracts the Pallas kernel's 1 - q * (1/1023)
//     into one rounding); each corner weight is rounded to bf16 and each
//     product w_c * dout_f is rounded to bf16 before it is added in float32
//     -- the steps of the Pallas kernel, term for term.
//   w3 (float32 compute): float32 weights, products and sums.
// The plain PyTorch versions (nerfacc_tpu_torch/ops/table_grad.py:
// table_grad_u10_plain, table_grad_w3_plain) do the same arithmetic; only the
// order of the float32 sums differs.  Built with --fmad=false.
//
// What bounds it: device memory.  At the training shape (2,097,152
// sample-levels, 131,072 rows) it reads 40 B per sample (row, weights, 32 B
// of bf16 cotangent) and writes a 64 MiB table: 151 MB, 0.045 ms at
// 3.35 TB/s; the arithmetic (8 x 16 multiply-adds a sample) is far below the
// card's rate.  The TPU kernel built one-hot matrices for the MXU; here the
// samples come sorted by row (torch.sort, outside the kernel), and each warp
// reduces one contiguous span of them: its 32 lanes x 4 features cover the
// 128 columns of a row, a run of equal rows is summed in registers and
// written once.  Only a run that crosses a span boundary is added with
// atomics.  Adding every term with an unsorted atomicAdd would serialise on
// the densely indexed coarse level (4096 rows receive a quarter of all
// samples).  One launch covers all levels: row ids are unique across them.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kF = 16;     // features per corner
constexpr int kRow = 128;  // 8 corners x 16 features

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void flush(float* out, int row, int col,
                                      const float (&acc)[4], bool atomic) {
  float* dst = out + static_cast<int64_t>(row) * kRow + col;
  if (atomic) {
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(dst + j, acc[j]);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

// kU10: dout is bf16 and the weights are u10-packed (wq); otherwise dout is
// float32 and the weights are wx, wy, wz.
template <bool kU10>
__global__ void __launch_bounds__(256)
    table_grad_kernel(const int32_t* __restrict__ sorted_idx,
                      const int64_t* __restrict__ perm,
                      const int32_t* __restrict__ wq,
                      const float* __restrict__ wx,
                      const float* __restrict__ wy,
                      const float* __restrict__ wz,
                      const void* __restrict__ dout, float* __restrict__ out,
                      int64_t n, int span, float inv1023) {
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t begin = warp * span;
  if (begin >= n) return;  // uniform across the warp
  const int64_t end = begin + span < n ? begin + span : n;

  // This lane's corner and its 4 features: columns c * 16 + f0 .. + 3.
  const int c = lane >> 2;
  const int f0 = (lane & 3) * 4;
  const int col = c * kF + f0;
  const bool hx = (c >> 2) & 1, hy = (c >> 1) & 1, hz = c & 1;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int cur = __ldg(sorted_idx + begin);
  // The first run is shared with the previous span if it started there.
  bool head = true;
  const bool head_shared = begin > 0 && __ldg(sorted_idx + begin - 1) == cur;

  for (int64_t base = begin; base < end; base += 32) {
    // Each lane loads one sample's row, source index and weights; the warp
    // then walks the 32 samples in order, broadcasting them by shuffle.
    const int64_t i = base + lane;
    const bool in = i < end;
    const int r_l = in ? __ldg(sorted_idx + i) : 0;
    const int64_t p_l = in ? __ldg(perm + i) : 0;
    int q_l = 0;
    float x_l = 0.f, y_l = 0.f, z_l = 0.f;
    if (in) {
      if (kU10) {
        q_l = __ldg(wq + p_l);
      } else {
        x_l = __ldg(wx + p_l);
        y_l = __ldg(wy + p_l);
        z_l = __ldg(wz + p_l);
      }
    }
    const int cnt = static_cast<int>(end - base < 32 ? end - base : 32);
    for (int j = 0; j < cnt; ++j) {
      const int r = __shfl_sync(kAll, r_l, j);
      const int64_t p = __shfl_sync(kAll, p_l, j);
      if (r != cur) {  // uniform: every lane sees the same row
        flush(out, cur, col, acc, head && head_shared);
        head = false;
        cur = r;
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] = 0.f;
      }
      float w;
      if (kU10) {
        const int q = __shfl_sync(kAll, q_l, j);
        const float qx = static_cast<float>((q >> 20) & 1023);
        const float qy = static_cast<float>((q >> 10) & 1023);
        const float qz = static_cast<float>(q & 1023);
        w = (hx ? qx * inv1023 : __fmaf_rn(-qx, inv1023, 1.f)) *
            (hy ? qy * inv1023 : __fmaf_rn(-qy, inv1023, 1.f));
        w = w * (hz ? qz * inv1023 : __fmaf_rn(-qz, inv1023, 1.f));
      } else {
        const float x = __shfl_sync(kAll, x_l, j);
        const float y = __shfl_sync(kAll, y_l, j);
        const float z = __shfl_sync(kAll, z_l, j);
        w = (hx ? x : 1.f - x) * (hy ? y : 1.f - y);
        w = w * (hz ? z : 1.f - z);
      }
      if (kU10) {
        w = bf16_round(w);
        const uint2 bits = __ldg(reinterpret_cast<const uint2*>(
            static_cast<const __nv_bfloat16*>(dout) + p * kF + f0));
        const float d[4] = {__uint_as_float(bits.x << 16),
                            __uint_as_float(bits.x & 0xffff0000u),
                            __uint_as_float(bits.y << 16),
                            __uint_as_float(bits.y & 0xffff0000u)};
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += bf16_round(w * d[k]);
      } else {
        const float4 d = __ldg(reinterpret_cast<const float4*>(
            static_cast<const float*>(dout) + p * kF + f0));
        acc[0] += w * d.x;
        acc[1] += w * d.y;
        acc[2] += w * d.z;
        acc[3] += w * d.w;
      }
    }
  }
  // The last run is shared with the next span if it goes on there.
  const bool tail_shared = end < n && __ldg(sorted_idx + end) == cur;
  flush(out, cur, col, acc, tail_shared || (head && head_shared));
}

int launch(bool u10, const int32_t* sorted_idx, const int64_t* perm,
           const int32_t* wq, const float* wx, const float* wy,
           const float* wz, const void* dout, float* out, long long n,
           int span, float inv1023, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long warps = (n + span - 1) / span;
  const long long blocks = (warps * 32 + threads - 1) / threads;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (u10) {
    table_grad_kernel<true><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        sorted_idx, perm, wq, nullptr, nullptr, nullptr, dout, out, n, span,
        inv1023);
  } else {
    table_grad_kernel<false><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        sorted_idx, perm, nullptr, wx, wy, wz, dout, out, n, span, inv1023);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int table_grad_u10_launch(const int32_t* sorted_idx,
                                     const int64_t* perm, const int32_t* wq,
                                     const void* dout, float* out, long long n,
                                     int span, float inv1023, void* stream) {
  return launch(true, sorted_idx, perm, wq, nullptr, nullptr, nullptr, dout,
                out, n, span, inv1023, stream);
}

extern "C" int table_grad_w3_launch(const int32_t* sorted_idx,
                                    const int64_t* perm, const float* wx,
                                    const float* wy, const float* wz,
                                    const void* dout, float* out, long long n,
                                    int span, float inv1023, void* stream) {
  return launch(false, sorted_idx, perm, nullptr, wx, wy, wz, dout, out, n,
                span, inv1023, stream);
}
