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
// The (row, fetch) pairs come sorted by the key row * n_fetches + fetch
// (torch.sort, outside the kernel), with the permutation that sorted the
// fetch-major pairs.  One call covers every fetch: a pre-pass that packs the
// positions, then the tile kernel.  A fetch has C = jg * F columns a corner
// and 8 C active columns; the kernel is a template over (jg, C) and takes
// every C in {1, 2, 4, 8, 16}, the column counts of every split
// (keys_per_row dividing J = 16 / F) of F in {1, 2, 4, 8, 16}.  A run is
// stored, not added, where no other walker holds part of it, so no two keys
// may name the same columns of a row: the wrapper refuses fetches that share
// a span and a window (j_lo), which the plain version would sum.  The
// encoder's fetches never do.
//
// What bounds it: device memory.  At the grouped training shape (2^19
// samples x 8 fetches = 2^22 pairs over 131,072 rows, jg = 2, F = 2, bf16)
// the function reads a 4 B key and 8 B of cotangent a pair and 12 B of
// position a sample, and writes a 64 MiB table: 124 MB, 0.037 ms at
// 3.35 TB/s.  Its arithmetic, 6 axis weights and 16 corner weights a pair
// (about 92 float operations) and 32 terms of a multiply and an add, is
// 6.5e8 operations, 0.010 ms at 67 TFLOP/s.  Beyond those bytes the kernel
// reads the int64 permutation (32 MB) and gathers at random addresses a
// 16 B position record and 2 C bytes of cotangent a pair, a whole 32 B
// sector each.
//
// Tiling.  A block takes a tile of consecutive sorted pairs (512, or 256 or
// 128 where a wider window's staging would pass 48 KB) in two phases split
// by a barrier.  The design it replaces had a warp's 32 lanes (its columns)
// walk 128 pairs one at a time, each lane rebuilding its weight and loading
// the pair's cotangent inside the walk.  Against that:
//  1. Per-pair work once per pair.  A thread stages one or two pairs: it
//     decodes each key once (fetch, row, the window's first column; the
//     pair's sample in 32-bit arithmetic), builds the jg x 3 axis
//     weights and the 8 x jg bf16 corner weights once, and stores them in
//     shared memory with the pair's cotangent and output offset.  The
//     per-fetch constants (resolutions, key sub-level, j_lo) are copied to
//     shared memory once a block.  The walk has no integer division and no
//     weight math: a lane forms bf16 products two at a time
//     (mul.rn.bf16x2) and adds them.
//  2. Every load of a tile in flight before the walk.  The keys and the
//     permutation are read contiguously (streamed: read once), then each
//     thread issues all its pairs' position and cotangent gathers before it
//     uses any of them.  The pre-pass makes a pair's position one 16 B
//     gather, not three of 4 B.
//  3. The load balance of the sorted spans.  A walker of S = min(32, 8 C)
//     lanes walks a contiguous share of the tile in order, four pairs at a
//     time: the tile is staged quad-major, so three shared loads bring a
//     lane four pairs' keys, weights and cotangents of one column.  A pair's
//     8 C columns are spread over the walker's lanes, 8 C / S a lane (at
//     C = 4 one warp, lane l corner l / 4 and window column l % 4; at C = 16
//     a warp, four columns a lane; at C = 1 and 2 a warp holds four and two
//     walkers).  A run of equal keys is summed in registers and stored once;
//     a run that goes on into the previous or the next walker's pairs (in
//     this tile or the next) is added with atomics, at that boundary only.
//     Work is balanced by pairs whatever the key skew: the coarse grids'
//     long runs become a few walkers' atomics, and one key over every pair
//     stays right.  The output must start zeroed.
// Four blocks an SM, not the seven that its shared memory would hold at
// C = 4: the gathers go through L1, and the coarse fetches' long runs read
// neighbouring records there, so L1 is worth more than the three blocks
// (kernel_variants.py).
// No tensor cores: a run's sum is formally weights^T x cotangent, but every
// term is rounded, bf16(w * d), before the float32 sum, and an MMA adds
// unrounded products, about a bf16 step a term away from the plain version.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRow = 128;
constexpr int kMaxFetches = 32;
constexpr int kMaxJg = 16;
constexpr int kMaxThreads = 256;
// Blocks resident on an SM: their tiles take that much of the SM's 228 KB of
// shared memory, and the rest of its 256 KB serves as L1 for the gathers.
constexpr int kBlocksPerSm = 4;
constexpr int kStaticSmem = 48 * 1024;

// Per-fetch constants, passed by value (a __grid_constant__ parameter, so the
// kernel indexes it in place, without a copy to local memory).
struct Fetches {
  float res[kMaxFetches][kMaxJg];  // resolutions of the window's sub-levels
  int j_lo[kMaxFetches];           // first sub-level of the window
  int key_k[kMaxFetches];          // the window's key sub-level, -1 for none
};

// A tile of TILE pairs staged in shared memory, quad-major: w[q][i] holds
// corner weight i (= c * JG + k) of pairs 4q .. 4q + 3, one bf16 each, and
// d[q][kf] their cotangents of window column kf, so a lane reads four pairs'
// operands in one 8-byte load.  Each quad's row is padded by 8 bytes: the
// eight quads that a warp's 32 threads stage then fall on distinct banks.
template <int JG, int C, int TILE>
struct Stage {
  uint2 w[TILE / 4][8 * JG + 1];
  uint2 d[TILE / 4][C + 1];
  long long dst[TILE];  // the pair's first output column, row * 128 + j_lo * F
  int4 key[TILE / 4];   // the pairs' keys, four a quad
  int key_before, key_after;  // the keys of the pairs just outside the tile
  float res[kMaxFetches][JG];
  int key_k[kMaxFetches];
  int col[kMaxFetches];  // j_lo * F
};

// The largest tile of 512, 256 or 128 pairs whose staging fits in the 48 KB
// of static shared memory: 512 up to C = 4 (about 29 KB at jg = 2 and 46 KB
// at jg = 4), less for the wide windows (jg = 16: 128 pairs, about 41 KB).
template <int JG, int C>
constexpr int tile_pairs() {
  return sizeof(Stage<JG, C, 512>) <= kStaticSmem   ? 512
         : sizeof(Stage<JG, C, 256>) <= kStaticSmem ? 256
                                                    : 128;
}

__device__ __forceinline__ float sub_level_weight(float x, float r, bool key) {
  const float xl = x * r;
  const float h = xl * 0.5f;
  const float tri = 1.f - fabsf(2.f * (h - floorf(h)) - 1.f);
  return key ? xl - floorf(xl) : tri;
}

// Two bf16 products, each the exact product rounded once to bf16, as
// bf16(float(w) * float(d)) is: the float32 product of two bf16 values is
// exact unless it falls below float32's normal range.
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ float lo_bf16(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

// Pair p's C bf16 cotangents, two a word (one 2, 4, 8 or 16 B load, or two
// of 16 B at C = 16).
template <int C>
__device__ __forceinline__ void load_cot(const void* dout, int64_t p, uint32_t (&v)[(C + 1) / 2]) {
  if constexpr (C == 1) {
    v[0] = __ldg(static_cast<const unsigned short*>(dout) + p);
  } else if constexpr (C == 2) {
    v[0] = __ldg(static_cast<const unsigned int*>(dout) + p);
  } else if constexpr (C == 4) {
    const uint2 t = __ldg(static_cast<const uint2*>(dout) + p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int h = 0; h < C / 8; ++h) {
      const uint4 t = __ldg(static_cast<const uint4*>(dout) + p * (C / 8) + h);
      v[4 * h] = t.x;
      v[4 * h + 1] = t.y;
      v[4 * h + 2] = t.z;
      v[4 * h + 3] = t.w;
    }
  }
}

// The pre-pass: each sample's position as one 16 B record, so a pair
// gathers one sector of it, not three.
__global__ void pack_positions_kernel(const float* __restrict__ xs,
                                      const float* __restrict__ ys,
                                      const float* __restrict__ zs,
                                      float4* __restrict__ pos, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) pos[i] = make_float4(__ldcs(xs + i), __ldcs(ys + i), __ldcs(zs + i), 0.f);
}

template <int JG, int C>
struct Shape {
  static constexpr int kTile = tile_pairs<JG, C>();                   // pairs a block
  static constexpr int kThreads = kTile < kMaxThreads ? kTile : kMaxThreads;
  static constexpr int kPairsPerThread = kTile / kThreads;
  static constexpr int kLanes = 8 * C < 32 ? 8 * C : 32;              // lanes a walker
  static constexpr int kColsPerLane = 8 * C / kLanes;
  static constexpr int kWalkerPairs = kTile / (kThreads / kLanes);    // pairs a walker walks
  static_assert(kWalkerPairs % 4 == 0, "a walker walks whole quads");
  static_assert(sizeof(Stage<JG, C, kTile>) <= kStaticSmem, "the stage fits in static shared memory");
};

template <int JG, int C>
__global__ void __launch_bounds__(Shape<JG, C>::kThreads)
    table_grad_pos_kernel(const int32_t* __restrict__ keys,
                          const int64_t* __restrict__ perm,
                          const float4* __restrict__ pos,
                          const void* __restrict__ dout,
                          float* __restrict__ out, int64_t n_pairs, int64_t n,
                          int n_fetches, const __grid_constant__ Fetches fetches) {
  using Sh = Shape<JG, C>;
  constexpr int F = C / JG;
  constexpr int kTile = Sh::kTile;
  constexpr int kThreads = Sh::kThreads;
  constexpr int kPairsPerThread = Sh::kPairsPerThread;
  constexpr int kWords = (C + 1) / 2;
  __shared__ Stage<JG, C, kTile> st;
  const int tid = threadIdx.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kTile;
  const int count =
      static_cast<int>(n_pairs - begin < kTile ? n_pairs - begin : kTile);

  // ---- 1. stage the tile: contiguous loads, constants, gathers, weights ----
  int key[kPairsPerThread];
  int64_t p[kPairsPerThread];
#pragma unroll
  for (int m = 0; m < kPairsPerThread; ++m) {
    const int i = tid + m * kThreads;
    // Read once: streamed, so they do not evict the gathered records.
    key[m] = i < count ? __ldcs(keys + begin + i) : 0;
    p[m] = i < count ? __ldcs(reinterpret_cast<const long long*>(perm) + begin + i) : 0;
  }
  for (int t = tid; t < n_fetches * JG; t += kThreads) st.res[t / JG][t % JG] = fetches.res[t / JG][t % JG];
  if (tid < n_fetches) {
    st.key_k[tid] = fetches.key_k[tid];
    st.col[tid] = fetches.j_lo[tid] * F;
  }
  if (tid == 0 && begin > 0) st.key_before = __ldg(keys + begin - 1);
  if (tid == 32 && begin + count < n_pairs) st.key_after = __ldg(keys + begin + count);
  __syncthreads();

  int g[kPairsPerThread];
  float4 q[kPairsPerThread];
  uint32_t dv[kPairsPerThread][kWords];
  int* skey = reinterpret_cast<int*>(st.key);
#pragma unroll
  for (int m = 0; m < kPairsPerThread; ++m) {
    const int i = tid + m * kThreads;
    g[m] = 0;
    if (i >= count) continue;
    g[m] = key[m] % n_fetches;
    const int row = key[m] / n_fetches;
    // Pair indices stay below 2^32 (the launch checks n_fetches * n).
    const uint32_t s = static_cast<uint32_t>(p[m]) % static_cast<uint32_t>(n);
    q[m] = __ldg(pos + s);
    load_cot<C>(dout, p[m], dv[m]);
    skey[i] = key[m];
    st.dst[i] = static_cast<long long>(row) * kRow + st.col[g[m]];
  }
#pragma unroll
  for (int m = 0; m < kPairsPerThread; ++m) {
    const int i = tid + m * kThreads;
    if (i >= count) continue;
    float ax[JG][2], ay[JG][2], az[JG][2];  // [k][0] = 1 - w, [k][1] = w
#pragma unroll
    for (int k = 0; k < JG; ++k) {
      const float r = st.res[g[m]][k];
      const bool is_key = st.key_k[g[m]] == k;
      ax[k][1] = sub_level_weight(q[m].x, r, is_key);
      ay[k][1] = sub_level_weight(q[m].y, r, is_key);
      az[k][1] = sub_level_weight(q[m].z, r, is_key);
      ax[k][0] = 1.f - ax[k][1];
      ay[k][0] = 1.f - ay[k][1];
      az[k][0] = 1.f - az[k][1];
    }
    unsigned short* w = reinterpret_cast<unsigned short*>(st.w[i >> 2]) + (i & 3);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int k = 0; k < JG; ++k) {
        const float wc = (ax[k][(c >> 2) & 1] * ay[k][(c >> 1) & 1]) * az[k][c & 1];
        w[4 * (c * JG + k)] = __bfloat16_as_ushort(__float2bfloat16_rn(wc));
      }
    }
    unsigned short* d = reinterpret_cast<unsigned short*>(st.d[i >> 2]) + (i & 3);
#pragma unroll
    for (int kf = 0; kf < C; ++kf) {
      d[4 * kf] = static_cast<unsigned short>(dv[m][kf / 2] >> (16 * (kf & 1)));
    }
  }
  __syncthreads();

  // ---- 2. the walk: walker v sums pairs [sb, se) of the tile --------------
  constexpr int kLanes = Sh::kLanes;
  constexpr int kCols = Sh::kColsPerLane;
  const int sb = (tid / kLanes) * Sh::kWalkerPairs;
  if (sb >= count) return;  // uniform across the walker
  const int se = sb + Sh::kWalkerPairs < count ? sb + Sh::kWalkerPairs : count;
  const int lane = tid % kLanes;
  int widx[kCols], kfs[kCols], col0[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    const int a = lane + u * kLanes;  // the pair's active column: corner a / C, window column a % C
    kfs[u] = a % C;                   // k * F + f
    widx[u] = (a / C) * JG + kfs[u] / F;
    col0[u] = (a / C) * (kRow / 8) + kfs[u];
  }

  int cur = skey[sb];
  long long cur_dst = st.dst[sb];
  // The first run is shared with the pairs before if it started there.
  const bool head_shared =
      begin + sb > 0 && (sb > 0 ? skey[sb - 1] : st.key_before) == cur;
  bool head = true;
  float acc[kCols];
#pragma unroll
  for (int u = 0; u < kCols; ++u) acc[u] = 0.f;
  for (int qd = sb / 4; qd < (se + 3) / 4; ++qd) {
    const int4 k4 = st.key[qd];
    const int ks[4] = {k4.x, k4.y, k4.z, k4.w};
    float ts[kCols][4];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      const uint2 w4 = st.w[qd][widx[u]];
      const uint2 d4 = st.d[qd][kfs[u]];
      const uint32_t t01 = mul_bf16x2(w4.x, d4.x);
      const uint32_t t23 = mul_bf16x2(w4.y, d4.y);
      ts[u][0] = lo_bf16(t01);
      ts[u][1] = hi_bf16(t01);
      ts[u][2] = lo_bf16(t23);
      ts[u][3] = hi_bf16(t23);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = 4 * qd + r;
      if (j >= se) break;  // the tile's last, partial quad
      if (ks[r] != cur) {  // uniform: every lane of the walker reads the same key
#pragma unroll
        for (int u = 0; u < kCols; ++u) {
          float* dst = out + cur_dst + col0[u];
          if (head && head_shared) {
            atomicAdd(dst, acc[u]);
          } else {
            *dst = acc[u];
          }
          acc[u] = 0.f;
        }
        head = false;
        cur = ks[r];
        cur_dst = st.dst[j];
      }
#pragma unroll
      for (int u = 0; u < kCols; ++u) acc[u] += ts[u][r];
    }
  }
  // The last run is shared with the pairs after if it goes on there.
  const bool tail_shared =
      begin + se < n_pairs && (se < count ? skey[se] : st.key_after) == cur;
#pragma unroll
  for (int u = 0; u < kCols; ++u) {
    float* dst = out + cur_dst + col0[u];
    if (tail_shared || (head && head_shared)) {
      atomicAdd(dst, acc[u]);
    } else {
      *dst = acc[u];
    }
  }
}

template <int JG, int C>
int launch(const int32_t* sorted_key, const int64_t* perm, const float4* pos,
           const void* dout, float* out, long long n_pairs, long long n,
           int n_fetches, const Fetches& fetches, cudaStream_t stream) {
  using Sh = Shape<JG, C>;
  // The shared memory / L1 split, once: the least shared memory that holds
  // kBlocksPerSm tiles (with the 1 KB the system reserves a block), in
  // percent of 228 KB, rounded up by the driver to a split it offers.
  static const cudaError_t carveout = cudaFuncSetAttribute(
      table_grad_pos_kernel<JG, C>, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>((kBlocksPerSm * (sizeof(Stage<JG, C, Sh::kTile>) + 1024) * 100 + 228 * 1024 - 1) /
                       (228 * 1024)));
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  const long long blocks = (n_pairs + Sh::kTile - 1) / Sh::kTile;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  table_grad_pos_kernel<JG, C><<<static_cast<unsigned>(blocks), Sh::kThreads, 0, stream>>>(
      sorted_key, perm, pos, dout, out, n_pairs, n, n_fetches, fetches);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// res: n_fetches * jg resolutions, fetch-major; j_lo, key_k: n_fetches each
// (host arrays).  dout must be aligned to min(16, 2 jg F) bytes, and `pos`
// scratch for n 16-byte records, 16-byte aligned.  Needs 8 * J * F == 128,
// jg * F in {1, 2, 4, 8, 16}, jg <= J and n_fetches * n < 2^32.
extern "C" int table_grad_pos_launch(const int32_t* sorted_key,
                                     const int64_t* perm, const float* xs,
                                     const float* ys, const float* zs,
                                     void* pos, const void* dout, float* out,
                                     long long n_pairs, long long n,
                                     int n_fetches, int jg, int F, int J,
                                     const float* res, const int* j_lo,
                                     const int* key_k, void* stream) {
  if (n_pairs <= 0) return 0;
  const int cols = jg * F;
  const int align = cols < 8 ? 2 * cols : 16;
  if (n_fetches <= 0 || n_fetches > kMaxFetches || jg <= 0 || jg > kMaxJg || jg > J ||
      (cols & (cols - 1)) != 0 || cols > 16 || 8 * J * F != kRow || n <= 0 ||
      n_fetches * n >= (1LL << 32) ||
      reinterpret_cast<uintptr_t>(dout) % align != 0 ||
      reinterpret_cast<uintptr_t>(pos) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pack_blocks = (n + kMaxThreads - 1) / kMaxThreads;
  if (pack_blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  Fetches fetches{};
  for (int g = 0; g < n_fetches; ++g) {
    for (int k = 0; k < jg; ++k) fetches.res[g][k] = res[g * jg + k];
    fetches.j_lo[g] = j_lo[g];
    fetches.key_k[g] = key_k[g];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* p4 = static_cast<float4*>(pos);
  pack_positions_kernel<<<static_cast<unsigned>(pack_blocks), kMaxThreads, 0, s>>>(xs, ys, zs, p4, n);
  // Every (jg, F) with jg * F a power of two up to 16 and jg <= 16 / F.
#define K6_INSTANCE(JG_, F_)                                                                       \
  if (jg == JG_ && F == F_) {                                                                       \
    return launch<JG_, JG_ * F_>(sorted_key, perm, p4, dout, out, n_pairs, n, n_fetches, fetches, s); \
  }
  K6_INSTANCE(1, 1) K6_INSTANCE(2, 1) K6_INSTANCE(4, 1) K6_INSTANCE(8, 1) K6_INSTANCE(16, 1)
  K6_INSTANCE(1, 2) K6_INSTANCE(2, 2) K6_INSTANCE(4, 2) K6_INSTANCE(8, 2)
  K6_INSTANCE(1, 4) K6_INSTANCE(2, 4) K6_INSTANCE(4, 4)
  K6_INSTANCE(1, 8) K6_INSTANCE(2, 8)
  K6_INSTANCE(1, 16)
#undef K6_INSTANCE
  return static_cast<int>(cudaErrorInvalidValue);
}
