// Table gradient of the fused hash encoder from w3 or w8 factors: kernel K4.
//
// Replaces the TPU kernel nerfacc_tpu/ops/table_grad.py:
//   table_grad_factors_sorted (_factor_kernel), wpack "w3" and "w8"  -> K4.
// (K2, the u10 mode of the same sum, is csrc/table_grad_u10.cu; this kernel
// is built on its design.)
// For each sample i with table row r_i, corner weights w_c(i) and output
// cotangent dout_i (16 features), it adds t(w_c(i) * dout_i[f]) in float32
// into out[r_i, c * 16 + f] for the 8 corners c = 4 dx + 2 dy + dz.  Four
// modes, one template: the weights arrive as
//   w3: the three fractions (wx, wy, wz), in bf16 or float32, and the corner
//       weight is the float32 product (wx' * wy') * wz', with x' = 1 - x
//       rounded once;
//   w8: the eight corner weights, in bf16 or float32, used as they are;
// and dout is bf16 or float32 alike.  In bf16 each corner weight is rounded
// to bf16 and each term w_c * dout_f is the exact product rounded once to
// bf16 (mul.rn.bf16x2) -- the steps of the Pallas kernel, term for term; in
// float32 t is a float32 multiply, and the sums are float32 adds.  The plain
// PyTorch versions (nerfacc_tpu_torch/ops/table_grad.py: table_grad_w3_plain,
// table_grad_w8_plain) do the same arithmetic; only the order of the float32
// sums differs.  Built with --fmad=false.
//
// What bounds it: device memory.  At the training shape (2,097,152
// sample-levels, 131,072 rows) w3 in float32 must read 80 B a sample (row,
// three fractions, 64 B of cotangent) and write a 64 MiB table: 235 MB,
// 0.070 ms at 3.35 TB/s; bf16 w3 42 B, bf16 w8 52 B, float32 w8 100 B a
// sample.  The arithmetic (the corner weights, 128 terms of a multiply and
// an add) is far below the card's rate.  Beyond those bytes the kernel reads
// the int64 permutation (16 MB) and gathers every sample's weights and
// cotangent at random addresses.  What bounded the warp-span walk this
// replaces was latency: one dependent gather a step in flight per warp.
//
// The samples come sorted by row (torch.sort, outside the kernel), with the
// permutation that sorted them.  A block takes one tile of consecutive
// sorted samples (Tile<T>::kSamples) in two phases split by a barrier:
//  1. Staging, per-sample work once per sample.  Thread t takes the quad of
//     samples 4t .. 4t + 3: it reads their rows and permutation entries with
//     16-byte streamed loads, starts every weight and cotangent gather of
//     the quad before it uses any, builds each sample's 8 corner weights
//     once, and stores the quad quad-major in shared memory (rows padded so
//     that the staging stores of neighbouring threads fall on distinct
//     banks).
//  2. The walk, balanced by samples whatever the key skew.  Each warp sums
//     128 samples of the tile in order, four at a time.  Lane l keeps
//     columns 4 l .. 4 l + 3 (corner l / 4, features 4 (l % 4) .. + 3); a
//     few shared loads bring it a quad's rows, its corner's four weights and
//     its features of the four cotangents.  A quad whose last row is the
//     current run's goes on with the run without a test a sample.  A run of
//     equal rows is summed in registers and stored once, 512 contiguous
//     bytes a warp; only a run that goes on into the previous or the next
//     warp's samples (in this tile or the next) is added with atomics, at
//     that boundary.  The output must start zeroed.
// The shared memory / L1 split is set for Tile<T>::kBlocksPerSm resident
// blocks: the gathers go through L1 (a sample's 16-byte cotangent loads meet
// there), so L1 is worth more than further blocks.  bf16 tiles take 256
// samples at eight blocks an SM, as K2's; float32 tiles, twice the bytes a
// sample, 128 at eight, about the same shared memory, which measured 2% to
// 3% faster than 256 at four and 9% to 20% faster than six or ten blocks of
// 128 (kernel_variants.py k4).
// No tensor cores: a run's sum is formally weights^T x cotangent, but in
// bf16 every term is rounded before the float32 sum, and an MMA adds
// unrounded products.  One launch covers all levels: row ids are unique
// across them.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRow = 128;  // 8 corners x 16 features

enum class Weights { kW3, kW8 };

// Samples a block stages, and blocks resident on an SM, for bf16 and float32
// inputs.  The resident tiles take that much of the SM's 228 KB of shared
// memory; the rest of its 256 KB serves as L1 for the gathers.
constexpr int kTileBf16 = 256;
constexpr int kBlocksPerSmBf16 = 8;
constexpr int kTileF32 = 128;
constexpr int kBlocksPerSmF32 = 8;

template <typename T>
struct Tile;

// bf16: d[q][2 g + h] holds features 4 g .. 4 g + 3 of samples 4 q + 2 h and
// 4 q + 2 h + 1 (8 bytes each); w[q][c] corner c's bf16 weight of samples
// 4 q .. 4 q + 3; key[q] their rows.  The last entry of each d and w row pads
// it: 14,864 bytes at 256 samples.
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int kSamples = kTileBf16;
  static constexpr int kBlocksPerSm = kBlocksPerSmBf16;
  static constexpr int kQuads = kSamples / 4;
  uint4 d[kQuads][9];
  int4 key[kQuads];
  uint2 w[kQuads][9];
  int key_before, key_after;  // the rows of the samples just outside the tile
};

// float32: d[q][4 r + g] holds features 4 g .. 4 g + 3 of sample 4 q + r;
// w[q][c] corner c's weight of samples 4 q .. 4 q + 3.  Padded as above:
// 13,840 bytes at 128 samples (one warp stages and walks them).
template <>
struct Tile<float> {
  static constexpr int kSamples = kTileF32;
  static constexpr int kBlocksPerSm = kBlocksPerSmF32;
  static constexpr int kQuads = kSamples / 4;
  float4 d[kQuads][17];
  int4 key[kQuads];
  float4 w[kQuads][9];
  int key_before, key_after;
};

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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Add (atomic) or store a lane's four sums at dst, then zero them.
__device__ __forceinline__ void flush(float* dst, float (&acc)[4], bool atomic) {
  if (atomic) {
#pragma unroll
    for (int j = 0; j < 4; ++j) atomicAdd(dst + j, acc[j]);
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
}

// A lane's operands of one staged quad: its corner's weight and its four
// features of each of the quad's four samples; add(r) adds sample r's terms.
template <typename T>
struct Quad;

template <>
struct Quad<__nv_bfloat16> {
  uint32_t w2[4];    // each sample's bf16 weight twice, (w, w)
  uint32_t d[4][2];  // each sample's features as two bf16 pairs
  __device__ __forceinline__ Quad(const Tile<__nv_bfloat16>& st, int q, int c, int g) {
    const uint2 w4 = st.w[q][c];
    const uint4 d01 = st.d[q][2 * g];
    const uint4 d23 = st.d[q][2 * g + 1];
    w2[0] = __byte_perm(w4.x, 0u, 0x1010);
    w2[1] = __byte_perm(w4.x, 0u, 0x3232);
    w2[2] = __byte_perm(w4.y, 0u, 0x1010);
    w2[3] = __byte_perm(w4.y, 0u, 0x3232);
    d[0][0] = d01.x, d[0][1] = d01.y, d[1][0] = d01.z, d[1][1] = d01.w;
    d[2][0] = d23.x, d[2][1] = d23.y, d[3][0] = d23.z, d[3][1] = d23.w;
  }
  __device__ __forceinline__ void add(int r, float (&acc)[4]) const {
    const uint32_t t01 = mul_bf16x2(w2[r], d[r][0]);
    const uint32_t t23 = mul_bf16x2(w2[r], d[r][1]);
    acc[0] += lo_bf16(t01);
    acc[1] += hi_bf16(t01);
    acc[2] += lo_bf16(t23);
    acc[3] += hi_bf16(t23);
  }
};

template <>
struct Quad<float> {
  float w[4];
  float4 d[4];
  __device__ __forceinline__ Quad(const Tile<float>& st, int q, int c, int g) {
    const float4 w4 = st.w[q][c];
    w[0] = w4.x, w[1] = w4.y, w[2] = w4.z, w[3] = w4.w;
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = st.d[q][4 * r + g];
  }
  __device__ __forceinline__ void add(int r, float (&acc)[4]) const {
    acc[0] += w[r] * d[r].x;
    acc[1] += w[r] * d[r].y;
    acc[2] += w[r] * d[r].z;
    acc[3] += w[r] * d[r].w;
  }
};

// dout and w8 are read as 16-byte words: kDoutWords for a sample's 16
// features, kW8Words for its 8 corner weights.
template <Weights kW, typename T>
__global__ void __launch_bounds__(Tile<T>::kSamples / 4)
    table_grad_kernel(const int32_t* __restrict__ keys, const int64_t* __restrict__ perm,
                      const T* __restrict__ wx, const T* __restrict__ wy, const T* __restrict__ wz,
                      const uint4* __restrict__ w8, const uint4* __restrict__ dout,
                      float* __restrict__ out, int64_t n) {
  using Stage = Tile<T>;
  constexpr int kTile = Stage::kSamples;
  constexpr int kThreads = kTile / 4;  // one staging thread a quad
  constexpr int kWarpSamples = kTile / (kThreads / 32);  // samples a warp walks
  constexpr int kDoutWords = 16 * sizeof(T) / 16;
  constexpr int kW8Words = 8 * sizeof(T) / 16;
  constexpr bool kBf16 = sizeof(T) == 2;
  __shared__ Stage st;
  const int tid = threadIdx.x;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kTile;
  const int count = static_cast<int>(n - begin < kTile ? n - begin : kTile);

  // ---- 1. stage the tile: thread t takes samples 4t .. 4t + 3 ------------
  const int i0 = 4 * tid;
  int k[4];
  long long p[4];
  if (i0 + 4 <= count) {
    // Read once: streamed, so they do not evict the gathered words.
    const int4 k4 = __ldcs(reinterpret_cast<const int4*>(keys + begin) + tid);
    const longlong2* pp = reinterpret_cast<const longlong2*>(perm + begin) + 2 * tid;
    const longlong2 p01 = __ldcs(pp);
    const longlong2 p23 = __ldcs(pp + 1);
    k[0] = k4.x, k[1] = k4.y, k[2] = k4.z, k[3] = k4.w;
    p[0] = p01.x, p[1] = p01.y, p[2] = p23.x, p[3] = p23.y;
  } else {  // the last tile's partial quad, or none of it
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool in = i0 + r < count;
      k[r] = in ? __ldcs(keys + begin + i0 + r) : 0;
      p[r] = in ? __ldcs(reinterpret_cast<const long long*>(perm) + begin + i0 + r) : -1;
    }
  }
  if (tid == 0 && begin > 0) st.key_before = __ldg(keys + begin - 1);
  if (tid == kThreads - 1 && begin + count < n) st.key_after = __ldg(keys + begin + count);
  // Every gather of the quad in flight before any is used.
  float a[4][3];            // w3: the fractions
  uint4 wv[4][kW8Words];    // w8: the corner weights
  uint4 dv[4][kDoutWords];  // the cotangents
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool in = p[r] >= 0;
    if constexpr (kW == Weights::kW3) {
      a[r][0] = in ? to_float(__ldg(wx + p[r])) : 0.f;
      a[r][1] = in ? to_float(__ldg(wy + p[r])) : 0.f;
      a[r][2] = in ? to_float(__ldg(wz + p[r])) : 0.f;
    } else {
#pragma unroll
      for (int j = 0; j < kW8Words; ++j) wv[r][j] = in ? __ldg(w8 + kW8Words * p[r] + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kDoutWords; ++j) dv[r][j] = in ? __ldg(dout + kDoutWords * p[r] + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  if (i0 < count) {
    // Each sample's 8 corner weights, once.
    float w[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if constexpr (kW == Weights::kW3) {
        float f[3][2];  // f[axis][0] = 1 - x, f[axis][1] = x
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          f[ax][1] = a[r][ax];
          f[ax][0] = 1.f - a[r][ax];
        }
#pragma unroll
        for (int c = 0; c < 8; ++c) w[r][c] = (f[0][(c >> 2) & 1] * f[1][(c >> 1) & 1]) * f[2][c & 1];
      } else {
        const uint32_t* bits = reinterpret_cast<const uint32_t*>(wv[r]);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if constexpr (kBf16) {
            w[r][c] = (c & 1) ? hi_bf16(bits[c >> 1]) : lo_bf16(bits[c >> 1]);
          } else {
            w[r][c] = __uint_as_float(bits[c]);
          }
        }
      }
    }
    if constexpr (kBf16) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        uint32_t b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) b[r] = __bfloat16_as_ushort(__float2bfloat16_rn(w[r][c]));
        st.w[tid][c] = make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
      }
      // dv[r][0]: sample r's features 0 .. 7, dv[r][1]: 8 .. 15.
      st.d[tid][0] = make_uint4(dv[0][0].x, dv[0][0].y, dv[1][0].x, dv[1][0].y);
      st.d[tid][1] = make_uint4(dv[2][0].x, dv[2][0].y, dv[3][0].x, dv[3][0].y);
      st.d[tid][2] = make_uint4(dv[0][0].z, dv[0][0].w, dv[1][0].z, dv[1][0].w);
      st.d[tid][3] = make_uint4(dv[2][0].z, dv[2][0].w, dv[3][0].z, dv[3][0].w);
      st.d[tid][4] = make_uint4(dv[0][1].x, dv[0][1].y, dv[1][1].x, dv[1][1].y);
      st.d[tid][5] = make_uint4(dv[2][1].x, dv[2][1].y, dv[3][1].x, dv[3][1].y);
      st.d[tid][6] = make_uint4(dv[0][1].z, dv[0][1].w, dv[1][1].z, dv[1][1].w);
      st.d[tid][7] = make_uint4(dv[2][1].z, dv[2][1].w, dv[3][1].z, dv[3][1].w);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) st.w[tid][c] = make_float4(w[0][c], w[1][c], w[2][c], w[3][c]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int j = 0; j < kDoutWords; ++j) {
          st.d[tid][4 * r + j] = make_float4(__uint_as_float(dv[r][j].x), __uint_as_float(dv[r][j].y),
                                             __uint_as_float(dv[r][j].z), __uint_as_float(dv[r][j].w));
        }
      }
    }
    st.key[tid] = make_int4(k[0], k[1], k[2], k[3]);
  }
  __syncthreads();

  // ---- 2. the walk: warp w sums samples [sb, se) of the tile --------------
  const int sb = (tid >> 5) * kWarpSamples;
  if (sb >= count) return;  // uniform across the warp
  const int se = sb + kWarpSamples < count ? sb + kWarpSamples : count;
  const int lane = tid & 31;
  const int c = lane >> 2, g = lane & 3;
  const int* skey = reinterpret_cast<const int*>(st.key);
  float* col = out + 4 * lane;

  int cur = skey[sb];
  // The first run is shared with the samples before if it started there.
  const bool head_shared = begin + sb > 0 && (sb > 0 ? skey[sb - 1] : st.key_before) == cur;
  bool head = true;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int qd = sb / 4; qd < (se + 3) / 4; ++qd) {
    const int4 k4 = st.key[qd];
    const Quad<T> quad(st, qd, c, g);
    if (k4.w == cur && 4 * qd + 4 <= se) {  // the whole quad goes on with the run
#pragma unroll
      for (int r = 0; r < 4; ++r) quad.add(r, acc);
      continue;
    }
    const int ks[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (4 * qd + r >= se) break;  // the tile's last, partial quad
      if (ks[r] != cur) {  // uniform: every lane reads the same row
        flush(col + static_cast<int64_t>(cur) * kRow, acc, head && head_shared);
        head = false;
        cur = ks[r];
      }
      quad.add(r, acc);
    }
  }
  // The last run is shared with the samples after if it goes on there.
  const bool tail_shared = begin + se < n && (se < count ? skey[se] : st.key_after) == cur;
  flush(col + static_cast<int64_t>(cur) * kRow, acc, tail_shared || (head && head_shared));
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

template <Weights kW, typename T>
int launch(const int32_t* sorted_idx, const int64_t* perm, const void* wx, const void* wy,
           const void* wz, const void* w8, const void* dout, float* out, long long n, int tile,
           void* stream) {
  using Stage = Tile<T>;
  if (n <= 0) return 0;
  if (tile != Stage::kSamples || misaligned(sorted_idx) || misaligned(perm) || misaligned(dout) ||
      (kW == Weights::kW8 && misaligned(w8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n + Stage::kSamples - 1) / Stage::kSamples;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // The shared memory / L1 split, once a mode: the least shared memory that
  // holds kBlocksPerSm tiles (with the 1 KB the system reserves a block), in
  // percent of 228 KB, rounded up by CUDA to a split it offers.
  static const cudaError_t carveout = cudaFuncSetAttribute(
      table_grad_kernel<kW, T>, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>((Stage::kBlocksPerSm * (sizeof(Stage) + 1024) * 100 + 228 * 1024 - 1) /
                       (228 * 1024)));
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  table_grad_kernel<kW, T><<<static_cast<unsigned>(blocks), Stage::kSamples / 4, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      sorted_idx, perm, static_cast<const T*>(wx), static_cast<const T*>(wy),
      static_cast<const T*>(wz), static_cast<const uint4*>(w8), static_cast<const uint4*>(dout),
      out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: wx, wy, wz and dout (N, 16) are bf16; else float32.  `tile`
// must be the kernel's samples a block for that type; sorted_idx, perm and
// dout must be 16-byte aligned; out a zeroed (n_rows, 128) float32 table.
extern "C" int table_grad_w3_launch(const int32_t* sorted_idx, const int64_t* perm,
                                    const void* wx, const void* wy, const void* wz,
                                    const void* dout, float* out, long long n, int tile,
                                    int bf16, void* stream) {
  if (bf16) {
    return launch<Weights::kW3, __nv_bfloat16>(sorted_idx, perm, wx, wy, wz, nullptr, dout, out,
                                               n, tile, stream);
  }
  return launch<Weights::kW3, float>(sorted_idx, perm, wx, wy, wz, nullptr, dout, out, n, tile,
                                     stream);
}

// bf16 != 0: w8 (N, 8) and dout (N, 16) are bf16; else float32.  As above,
// and w8 must be 16-byte aligned too.
extern "C" int table_grad_w8_launch(const int32_t* sorted_idx, const int64_t* perm,
                                    const void* w8, const void* dout, float* out, long long n,
                                    int tile, int bf16, void* stream) {
  if (bf16) {
    return launch<Weights::kW8, __nv_bfloat16>(sorted_idx, perm, nullptr, nullptr, nullptr, w8,
                                               dout, out, n, tile, stream);
  }
  return launch<Weights::kW8, float>(sorted_idx, perm, nullptr, nullptr, nullptr, w8, dout, out,
                                     n, tile, stream);
}
