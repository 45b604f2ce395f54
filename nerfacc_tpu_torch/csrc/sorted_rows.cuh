// The warp-span skeleton of one of the port's table-gradient kernels: K5
// (csrc/table_grad_sorted.cu) is its only user.  K2, K4 and K6 have tile
// kernels of their own (csrc/table_grad_u10.cu, csrc/table_grad.cu,
// csrc/table_grad_pos.cu).
//
// Samples arrive sorted by an int32 key that names their output row.  Each
// warp reduces one contiguous span of `span` sorted samples: its lanes load
// 32 samples at a time, then the warp walks them in order, broadcasting each
// by shuffle.  A run of equal keys is summed in registers and written once;
// only a run that goes on into the previous or the next span is added with
// atomics.  The output must start zeroed.
//
// An Op supplies the per-sample work:
//   Op::Sample         what a lane loads for one sample, with shfl(j);
//   load(i)            the Sample of sorted position i;
//   add(sample, key)   add the sample's terms to this lane's accumulators;
//   flush(key, atomic) write the accumulators of the run `key`, zero them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

constexpr unsigned kAllLanes = 0xffffffffu;

// Four consecutive values at p, as float.
__device__ __forceinline__ void load4(const float* p, float (&d)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  d[0] = v.x;
  d[1] = v.y;
  d[2] = v.z;
  d[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&d)[4]) {
  const uint2 bits = __ldg(reinterpret_cast<const uint2*>(p));
  d[0] = __uint_as_float(bits.x << 16);
  d[1] = __uint_as_float(bits.x & 0xffff0000u);
  d[2] = __uint_as_float(bits.y << 16);
  d[3] = __uint_as_float(bits.y & 0xffff0000u);
}

// Add (atomic) or store four accumulators at dst, then zero them.
__device__ __forceinline__ void flush4(float* dst, float (&acc)[4],
                                       bool atomic) {
  if (atomic) {
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(dst + j, acc[j]);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
}

__device__ __forceinline__ int64_t shfl64(int64_t v, int j) {
  return __shfl_sync(kAllLanes, v, j);
}

template <class Op>
__device__ __forceinline__ void sum_sorted_span(const int32_t* __restrict__ keys,
                                                int64_t n, int span, Op& op) {
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t begin = warp * span;
  if (begin >= n) return;  // uniform across the warp
  const int64_t end = begin + span < n ? begin + span : n;

  int cur = __ldg(keys + begin);
  // The first run is shared with the previous span if it started there.
  bool head = true;
  const bool head_shared = begin > 0 && __ldg(keys + begin - 1) == cur;
  for (int64_t base = begin; base < end; base += 32) {
    const int64_t i = base + lane;
    const bool in = i < end;
    const int key_l = in ? __ldg(keys + i) : 0;
    typename Op::Sample s_l{};
    if (in) s_l = op.load(i);
    const int cnt = static_cast<int>(end - base < 32 ? end - base : 32);
    for (int j = 0; j < cnt; ++j) {
      const int key = __shfl_sync(kAllLanes, key_l, j);
      const typename Op::Sample s = s_l.shfl(j);
      if (key != cur) {  // uniform: every lane sees the same key
        op.flush(cur, head && head_shared);
        head = false;
        cur = key;
      }
      op.add(s, key);
    }
  }
  // The last run is shared with the next span if it goes on there.
  const bool tail_shared = end < n && __ldg(keys + end) == cur;
  op.flush(cur, tail_shared || (head && head_shared));
}

// Blocks of 256 threads for n sorted samples at `span` a warp; 0 if the grid
// would be too large.
inline unsigned sorted_span_blocks(long long n, int span) {
  const long long warps = (n + span - 1) / span;
  const long long blocks = (warps * 32 + 255) / 256;
  return blocks >= (1LL << 31) ? 0u : static_cast<unsigned>(blocks);
}
