// Table gradient of the grouped hash encoder, weights rebuilt from positions.
//
// Replaces the TPU kernel nerfacc_tpu/ops/table_grad.py:
// table_grad_factors_sorted_pos (kernel body _factor_kernel_pos) -> K6.
// A 128-wide table row holds J sub-levels x 8 corners x F features (column
// c * J * F + j * F + f).  Fetch g of a sample reads one row and uses the
// window of jg sub-levels [j_lo, j_lo + jg); each sub-level k of the window
// has its own resolution r_k, and its trilinear weights come from the
// sample's float32 position (x, y, z):
//   the key sub-level: true fractions  x r - floor(x r);
//   the others: the triangle wave      1 - |2 (h - floor h) - 1|, h = x r / 2.
// The corner weight is the float32 product (wx' * wy') * wz', rounded to
// bf16, and each term bf16(w * dout) is added in float32 into
//   out[row, c * J * F + (j_lo + k) * F + f].
// Columns outside a fetch's window receive nothing from it; fetches of one
// span with other windows write other columns.  XLA on the CPU rounds x * r
// before the subtraction (no fused multiply-add there), so the kernel is
// built with --fmad=false and the plain PyTorch version
// (nerfacc_tpu_torch/ops/table_grad.py:table_grad_pos_plain) repeats the same
// float32 steps; only the order of the float32 sums differs.
//
// Layout of the work: the (row, fetch) pairs come sorted by the key
// row * n_fetches + fetch (torch.sort, outside the kernel), with the
// permutation that sorted the fetch-major samples, and one launch covers
// every fetch.  Each warp reduces one contiguous span of sorted pairs
// (csrc/sorted_rows.cuh); its 32 lanes are the fetch's 32 active columns
// (8 * jg * F == 32): lane l is corner l / (jg F), sub-level
// (l % (jg F)) / F and feature l % F, and computes its own corner weight.
//
// What bounds it: device memory.  At the grouped training shape (524,288
// samples x 8 fetches, 131,072 rows, bf16) it must read a 4 B row, 8 B of
// bf16 cotangent and (once per sample) 12 B of position, and write a
// 64 MiB table: 124 MB, 0.037 ms at 3.35 TB/s.  The weights cost some 40
// float operations per lane and pair, far below the card's rate.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"
#include "sorted_rows.cuh"

namespace {

constexpr int kRow = 128;
constexpr int kMaxFetches = 32;
constexpr int kMaxJg = 4;

// Per-fetch constants, passed by value (a __grid_constant__ parameter, so the
// kernel indexes it in place, without a copy to local memory).
struct Fetches {
  float res[kMaxFetches][kMaxJg];  // resolutions of the window's sub-levels
  int j_lo[kMaxFetches];           // first sub-level of the window
  int key_k[kMaxFetches];          // the window's key sub-level, -1 for none
};

__device__ __forceinline__ float sub_level_weight(float x, float r, bool key) {
  const float xl = x * r;
  if (key) return xl - floorf(xl);
  const float h = xl * 0.5f;
  return 1.f - fabsf(2.f * (h - floorf(h)) - 1.f);
}

struct PosOp {
  struct Sample {
    int64_t p = 0;  // index of the (fetch, sample) pair, fetch-major
    float x = 0.f, y = 0.f, z = 0.f;
    __device__ Sample shfl(int j) const {
      Sample s;
      s.p = shfl64(p, j);
      s.x = __shfl_sync(kAllLanes, x, j);
      s.y = __shfl_sync(kAllLanes, y, j);
      s.z = __shfl_sync(kAllLanes, z, j);
      return s;
    }
  };

  const int64_t* perm;
  const float* xs;
  const float* ys;
  const float* zs;
  const __nv_bfloat16* dout;  // (n_fetches * n, jg * F)
  float* out;
  const Fetches* fetches;
  int64_t n;  // samples
  int n_fetches, jgf, F;
  int k, f;        // this lane's sub-level in the window and feature
  int col0;        // this lane's column without the window offset
  bool hx, hy, hz;
  float acc;

  __device__ Sample load(int64_t i) const {
    Sample s;
    s.p = __ldg(perm + i);
    const int64_t sample = s.p % n;
    s.x = __ldg(xs + sample);
    s.y = __ldg(ys + sample);
    s.z = __ldg(zs + sample);
    return s;
  }

  __device__ void add(const Sample& s, int key) {
    const int g = key % n_fetches;
    const float r = fetches->res[g][k];
    const bool is_key = fetches->key_k[g] == k;
    const float wx = sub_level_weight(s.x, r, is_key);
    const float wy = sub_level_weight(s.y, r, is_key);
    const float wz = sub_level_weight(s.z, r, is_key);
    float w = (hx ? wx : 1.f - wx) * (hy ? wy : 1.f - wy);
    w = bf16_round(w * (hz ? wz : 1.f - wz));
    const float d = __bfloat162float(__ldg(dout + s.p * jgf + k * F + f));
    acc += bf16_round(w * d);
  }

  __device__ void flush(int key, bool atomic) {
    const int g = key % n_fetches;
    float* dst = out + static_cast<int64_t>(key / n_fetches) * kRow + col0 +
                 fetches->j_lo[g] * F;
    if (atomic) {
      atomicAdd(dst, acc);
    } else {
      *dst = acc;
    }
    acc = 0.f;
  }
};

__global__ void __launch_bounds__(256)
    table_grad_pos_kernel(const int32_t* __restrict__ sorted_key,
                          const int64_t* __restrict__ perm,
                          const float* __restrict__ xs,
                          const float* __restrict__ ys,
                          const float* __restrict__ zs,
                          const __nv_bfloat16* __restrict__ dout,
                          float* __restrict__ out, int64_t n_pairs, int64_t n,
                          int span, int n_fetches, int jg, int F, int J,
                          const __grid_constant__ Fetches fetches) {
  const int lane = threadIdx.x & 31;
  const int jgf = jg * F;
  const int c = lane / jgf;
  PosOp op;
  op.perm = perm;
  op.xs = xs;
  op.ys = ys;
  op.zs = zs;
  op.dout = dout;
  op.out = out;
  op.fetches = &fetches;
  op.n = n;
  op.n_fetches = n_fetches;
  op.jgf = jgf;
  op.F = F;
  op.k = (lane % jgf) / F;
  op.f = lane % F;
  op.col0 = c * J * F + op.k * F + op.f;
  op.hx = (c >> 2) & 1;
  op.hy = (c >> 1) & 1;
  op.hz = c & 1;
  op.acc = 0.f;
  sum_sorted_span(sorted_key, n_pairs, span, op);
}

}  // namespace

// res: n_fetches * jg resolutions, fetch-major; j_lo, key_k: n_fetches each
// (host arrays).  Needs 8 * jg * F == 32, jg * F * J * 8 == 128.
extern "C" int table_grad_pos_launch(const int32_t* sorted_key,
                                     const int64_t* perm, const float* xs,
                                     const float* ys, const float* zs,
                                     const void* dout, float* out,
                                     long long n_pairs, int span, long long n,
                                     int n_fetches, int jg, int F, int J,
                                     const float* res, const int* j_lo,
                                     const int* key_k, void* stream) {
  if (n_pairs <= 0) return 0;
  if (n_fetches <= 0 || n_fetches > kMaxFetches || jg <= 0 || jg > kMaxJg ||
      8 * jg * F != 32 || 8 * J * F != kRow || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Fetches fetches{};
  for (int g = 0; g < n_fetches; ++g) {
    for (int k = 0; k < jg; ++k) fetches.res[g][k] = res[g * jg + k];
    fetches.j_lo[g] = j_lo[g];
    fetches.key_k[g] = key_k[g];
  }
  const unsigned blocks = sorted_span_blocks(n_pairs, span);
  if (blocks == 0) return static_cast<int>(cudaErrorInvalidValue);
  table_grad_pos_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      sorted_key, perm, xs, ys, zs, static_cast<const __nv_bfloat16*>(dout), out,
      n_pairs, n, span, n_fetches, jg, F, J, fetches);
  return static_cast<int>(cudaGetLastError());
}
