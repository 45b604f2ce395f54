// Table gradient of the fused hash encoder from u10 weights: kernel K2.
//
// Replaces the TPU kernel nerfacc_tpu/ops/table_grad.py:
// table_grad_factors_sorted_u10 (kernel body _factor_kernel_u10) -> K2.
// For each sample i with table row r_i, three 10-bit fractions packed in one
// int32 wq_i = qx << 20 | qy << 10 | qz and the bf16 output cotangent dout_i
// (16 features), it adds bf16(w_c(i) * dout_i[f]) in float32 into
// out[r_i, c * 16 + f] for the 8 corners c = 4 dx + 2 dy + dz.  A fraction
// is q * (1/1023) and its complement fma(-q, 1/1023, 1) (XLA contracts the
// Pallas kernel's 1 - q * (1/1023) into one rounding); the corner weight is
// the float32 product (wx' * wy') * wz', rounded to bf16.  The plain PyTorch
// version (nerfacc_tpu_torch/ops/table_grad.py:table_grad_u10_plain) does
// the same arithmetic; only the order of the float32 sums differs.  Built
// with --fmad=false.
//
// What bounds it: device memory.  At the training shape (2,097,152
// sample-levels, 131,072 rows) the function reads 40 B a sample (row,
// weights, 32 B of bf16 cotangent) and writes a 64 MiB table: 151 MB,
// 0.045 ms at 3.35 TB/s; the arithmetic (the 8 corner weights, 128 terms of
// a multiply and an add) is far below the card's rate.  Beyond those bytes
// the kernel reads the int64 permutation (16 MB) and gathers at random
// addresses the 4 B weights word and the 32 B cotangent of each sample, a
// whole 32 B sector each.  What bounded the design it replaces was latency:
// each warp walked 128 sorted samples one at a time, with one dependent
// cotangent gather a step, so a warp had about one gather in flight.
//
// The samples come sorted by row (torch.sort, outside the kernel), with the
// permutation that sorted them.  A block of 64 threads takes 256 consecutive
// sorted samples in two phases split by a barrier:
//  1. Staging, per-sample work once per sample.  Thread t stages the quad of
//     samples 4t .. 4t + 3: it reads their rows and permutation entries
//     with 16-byte loads (streamed: read once), starts all four weights and
//     eight cotangent gathers before it uses any, then decodes each u10 word
//     and builds its 8 bf16 corner weights once.  The tile is stored
//     quad-major in shared memory: for each quad, a corner's four weights in
//     one 8-byte word and a feature group's four cotangents in two 16-byte
//     words (rows padded so that the staging stores fall on distinct banks).
//  2. The walk, balanced by samples whatever the key skew.  Warp w sums
//     samples [128 w, 128 w + 128) of the tile in order, four at a time.
//     Lane l keeps columns 4 l .. 4 l + 3 (corner l / 4, features
//     4 (l % 4) .. + 3); four shared loads bring it a quad's rows, weights
//     and cotangents, and it forms two terms with one mul.rn.bf16x2 (the
//     exact product of two bf16 values rounded once, as the plain version
//     rounds it) and adds them in float32.  A quad whose last row is the
//     current run's goes on with the run without a test a sample.  A run of
//     equal rows is summed in registers and stored once, 512 contiguous
//     bytes a warp; a run that goes on into the previous or the next warp's
//     samples (in this tile or the next) is added with atomics, at that
//     boundary only.  The dense coarse level (a quarter of the samples on
//     4096 rows) becomes a few warps' atomics a row, and one row over every
//     sample stays right.  The output must start zeroed.
// Eight blocks an SM, about half of its shared memory: the gathers go
// through L1 (a sample's two 16-byte cotangent loads meet there, and the u10
// words of samples that neighbour each other along a ray share sectors), so
// L1 is worth more than further blocks, and 256-sample tiles beat 512 at the
// same shared memory (kernel_variants.py).  No tensor cores: a run's sum is
// formally weights^T x cotangent, but every term is rounded, bf16(w * d),
// before the float32 sum, and an MMA adds unrounded products.  One launch
// covers all levels: row ids are unique across them.

#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRow = 128;            // 8 corners x 16 features
constexpr int kTile = 256;           // samples a block
constexpr int kQuads = kTile / 4;    // one staging thread a quad
constexpr int kThreads = kQuads;
constexpr int kWarpSamples = kTile / (kThreads / 32);  // samples a warp walks
// Blocks resident on an SM: their tiles take that much of the SM's 228 KB of
// shared memory, and the rest of its 256 KB serves as L1 for the gathers.
constexpr int kBlocksPerSm = 8;

// A tile staged in shared memory, quad-major.  d[q][2 g + h] holds features
// 4 g .. 4 g + 3 of samples 4 q + 2 h and 4 q + 2 h + 1 (8 bytes each);
// w[q][c] corner c's bf16 weight of samples 4 q .. 4 q + 3; key[q] their
// rows.  The last entry of each d and w row pads it (144 and 72 bytes), so
// the quads that neighbouring threads stage fall on distinct banks: 14,864
// bytes.
struct Stage {
  uint4 d[kQuads][9];
  int4 key[kQuads];
  uint2 w[kQuads][9];
  int key_before, key_after;  // the rows of the samples just outside the tile
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

// The 8 bf16 corner weights of the u10 word q.
__device__ __forceinline__ void corner_weights(int q, float inv1023, uint32_t (&w)[8]) {
  float a[3][2];  // a[axis][0] = 1 - w, a[axis][1] = w
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float qk = static_cast<float>((q >> (20 - 10 * k)) & 1023);
    a[k][1] = qk * inv1023;
    a[k][0] = __fmaf_rn(-qk, inv1023, 1.f);
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float wc = (a[0][(c >> 2) & 1] * a[1][(c >> 1) & 1]) * a[2][c & 1];
    w[c] = __bfloat16_as_ushort(__float2bfloat16_rn(wc));
  }
}

// A lane's four terms of one sample, bf16(w * d) for its four features:
// w2 holds the sample's corner weight twice, d01 and d23 its feature pairs.
__device__ __forceinline__ void add_terms(uint32_t w2, uint32_t d01, uint32_t d23,
                                          float (&acc)[4]) {
  const uint32_t t01 = mul_bf16x2(w2, d01);
  const uint32_t t23 = mul_bf16x2(w2, d23);
  acc[0] += lo_bf16(t01);
  acc[1] += hi_bf16(t01);
  acc[2] += lo_bf16(t23);
  acc[3] += hi_bf16(t23);
}

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

__global__ void __launch_bounds__(kThreads)
    table_grad_u10_kernel(const int32_t* __restrict__ keys,
                          const int64_t* __restrict__ perm,
                          const int32_t* __restrict__ wq,
                          const uint4* __restrict__ dout,
                          float* __restrict__ out, int64_t n, float inv1023) {
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
  if (tid == 32 && begin + count < n) st.key_after = __ldg(keys + begin + count);
  // Every gather of the quad in flight before any is used.
  int q[4];
  uint4 da[4], db[4];  // features 0 .. 7 and 8 .. 15
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    q[r] = 0;
    da[r] = db[r] = make_uint4(0u, 0u, 0u, 0u);
    if (p[r] >= 0) {
      q[r] = __ldg(wq + p[r]);
      da[r] = __ldg(dout + 2 * p[r]);
      db[r] = __ldg(dout + 2 * p[r] + 1);
    }
  }
  if (i0 < count) {
    uint32_t w[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) corner_weights(q[r], inv1023, w[r]);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      st.w[tid][c] = make_uint2(w[0][c] | (w[1][c] << 16), w[2][c] | (w[3][c] << 16));
    }
    st.d[tid][0] = make_uint4(da[0].x, da[0].y, da[1].x, da[1].y);
    st.d[tid][1] = make_uint4(da[2].x, da[2].y, da[3].x, da[3].y);
    st.d[tid][2] = make_uint4(da[0].z, da[0].w, da[1].z, da[1].w);
    st.d[tid][3] = make_uint4(da[2].z, da[2].w, da[3].z, da[3].w);
    st.d[tid][4] = make_uint4(db[0].x, db[0].y, db[1].x, db[1].y);
    st.d[tid][5] = make_uint4(db[2].x, db[2].y, db[3].x, db[3].y);
    st.d[tid][6] = make_uint4(db[0].z, db[0].w, db[1].z, db[1].w);
    st.d[tid][7] = make_uint4(db[2].z, db[2].w, db[3].z, db[3].w);
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
  const bool head_shared =
      begin + sb > 0 && (sb > 0 ? skey[sb - 1] : st.key_before) == cur;
  bool head = true;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int qd = sb / 4; qd < (se + 3) / 4; ++qd) {
    const int4 k4 = st.key[qd];
    const uint2 w4 = st.w[qd][c];
    const uint4 d01 = st.d[qd][2 * g];
    const uint4 d23 = st.d[qd][2 * g + 1];
    const int ks[4] = {k4.x, k4.y, k4.z, k4.w};
    // Each sample's weight twice, (w, w), against its feature pairs.
    const uint32_t ws[4] = {__byte_perm(w4.x, 0u, 0x1010), __byte_perm(w4.x, 0u, 0x3232),
                            __byte_perm(w4.y, 0u, 0x1010), __byte_perm(w4.y, 0u, 0x3232)};
    const uint32_t ds[4][2] = {{d01.x, d01.y}, {d01.z, d01.w}, {d23.x, d23.y}, {d23.z, d23.w}};
    if (k4.w == cur && 4 * qd + 4 <= se) {  // the whole quad goes on with the run
#pragma unroll
      for (int r = 0; r < 4; ++r) add_terms(ws[r], ds[r][0], ds[r][1], acc);
      continue;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (4 * qd + r >= se) break;  // the tile's last, partial quad
      if (ks[r] != cur) {  // uniform: every lane reads the same row
        flush(col + static_cast<int64_t>(cur) * kRow, acc, head && head_shared);
        head = false;
        cur = ks[r];
      }
      add_terms(ws[r], ds[r][0], ds[r][1], acc);
    }
  }
  // The last run is shared with the samples after if it goes on there.
  const bool tail_shared =
      begin + se < n && (se < count ? skey[se] : st.key_after) == cur;
  flush(col + static_cast<int64_t>(cur) * kRow, acc, tail_shared || (head && head_shared));
}

}  // namespace

// `tile` must be the kernel's 256 samples a block; sorted_idx, perm and dout
// (N, 16) bf16 must be 16-byte aligned; out a zeroed (n_rows, 128) float32
// table.
extern "C" int table_grad_u10_launch(const int32_t* sorted_idx,
                                     const int64_t* perm, const int32_t* wq,
                                     const void* dout, float* out, long long n,
                                     int tile, float inv1023, void* stream) {
  if (n <= 0) return 0;
  if (tile != kTile || reinterpret_cast<uintptr_t>(sorted_idx) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(perm) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(dout) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // The shared memory / L1 split, once: the least shared memory that holds
  // kBlocksPerSm tiles (with the 1 KB the system reserves a block), in
  // percent of 228 KB, rounded up by CUDA to a split it offers.
  static const cudaError_t carveout = cudaFuncSetAttribute(
      table_grad_u10_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      static_cast<int>((kBlocksPerSm * (sizeof(Stage) + 1024) * 100 + 228 * 1024 - 1) /
                       (228 * 1024)));
  if (carveout != cudaSuccess) return static_cast<int>(carveout);
  table_grad_u10_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      sorted_idx, perm, wq, static_cast<const uint4*>(dout), out, n, inv1023);
  return static_cast<int>(cudaGetLastError());
}
