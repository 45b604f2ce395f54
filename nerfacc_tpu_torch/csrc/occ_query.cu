// Occupancy query: is the cell containing each point occupied?
//
// Replaces the TPU kernel nerfacc_tpu/ops/occ_query.py:occupancy_query_pallas
// (kernel body _query_kernel), and computes the multi-level semantics of
// nerfacc_tpu/grid.py:_query_soa in one launch for all levels, with the same
// float arithmetic: IEEE division by the box extent, the exponent of the
// largest coordinate for the mip level, an exact power of two for the level
// scale, truncation toward zero, then the clamp.  Built with --fmad=false, so
// no multiply-add is contracted and a point on a cell face lands in the same
// cell as in the plain PyTorch version
// (nerfacc_tpu_torch/ops/occ_query.py:occupancy_query_plain).
//
// Non-finite points follow the plain version and the JAX package: the
// largest coordinate is taken as an integer max of the magnitudes' bits,
// which carries a NaN through as torch.maximum does (fmaxf would drop it);
// the exponent is read from the bits, 0 for inf and NaN as torch.frexp gives
// (frexpf leaves it unspecified there); and __float2int_rz saturates, NaN to
// 0, as XLA's cast does.
//
// Grid layout: (levels, rx, ry, words) 32-bit words, bit b of word
// [l, ix, iy, w] is cell (l, ix, iy, 32 * w + b).
//
// What bounds it: latency.  At the render shape (2^20 queries on the 128^3
// grid) it moves 13.9 MB, 0.0041 ms at 3.35 TB/s, and the inputs are warm in
// the 50 MB L2.  A query is a chain: its coordinates, three divisions, then a
// dependent read of the grid word, then the store.  One query a thread, in
// 256-thread blocks, took 0.0091 ms.  Here a thread takes four consecutive
// queries: it reads their coordinates with three 16-byte loads, issues all of
// its grid-word reads (4, or 8 with mip_pad = 1) before it uses any, and
// stores the four result bytes as one 32-bit word; the grid is one wave of
// resident blocks with a grid-stride loop, so no partial wave trails.  The
// 128^3 level (256 KB of bits) stays in L2, read through __ldg.  Measured on
// an H100 80GB HBM3 at 700 W (kernel_variants.py k1): 0.0063 ms, 65% of the
// bound; an empty launch takes 0.0016 ms of it and the grid reads 0.0005.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kPointOneBits = 0x3dcccccdu;  // 0.1f, the mip clamp

struct Box {
  float x0, y0, z0, ex, ey, ez;
};

struct Grid {
  const uint32_t* packed;
  int levels, rx, ry, rz, words;
};

// The mip level of a normalised point: max(|nx|, |ny|, |nz|), clamped below
// at 0.1, its frexp exponent + 1, clamped below at 0.  Magnitudes order like
// their bits as unsigned integers, with every NaN above inf, so the integer
// max keeps a NaN.  A normal m = f * 2^e, f in [0.5, 1), has e = field - 126;
// m >= 0.1 is normal, and inf and NaN (field 255) take e = 0.
__device__ __forceinline__ int mip_level(float nx, float ny, float nz) {
  const uint32_t m = max(max(__float_as_uint(nx) & 0x7fffffffu, __float_as_uint(ny) & 0x7fffffffu),
                         max(__float_as_uint(nz) & 0x7fffffffu, kPointOneBits));
  const int field = static_cast<int>(m >> 23);
  const int e = field == 255 ? 0 : field - 126;
  return max(e + 1, 0);
}

__device__ __forceinline__ int cell(float n, float s, int r) {
  return min(max(__float2int_rz((n * s + 0.5f) * r), 0), r - 1);
}

// Occupancy of Q points: every grid word is read before any is used.  The
// level is clamped to the grid and the cells to their axes, so each read is
// in range, also for a point outside the selector (masked after).
template <int Q, int kPad>
__device__ __forceinline__ void query(const float (&px)[Q], const float (&py)[Q],
                                      const float (&pz)[Q], const Box& b,
                                      const Grid& g, uint32_t (&hit)[Q]) {
  uint32_t word[Q][kPad + 1];
  int shift[Q][kPad + 1];
  bool inside[Q];
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    const float nx = (px[k] - b.x0) / b.ex - 0.5f;
    const float ny = (py[k] - b.y0) / b.ey - 0.5f;
    const float nz = (pz[k] - b.z0) / b.ez - 0.5f;
    const int mip = mip_level(nx, ny, nz);
    inside[k] = mip < g.levels;  // the selector: inside the outermost level
#pragma unroll
    for (int dp = 0; dp <= kPad; ++dp) {
      const int mp = min(mip + dp, g.levels - 1);
      const float s = __uint_as_float(static_cast<uint32_t>(127 - mp) << 23);  // exact 2^-mp
      const int ix = cell(nx, s, g.rx), iy = cell(ny, s, g.ry), iz = cell(nz, s, g.rz);
      word[k][dp] = __ldg(g.packed + ((mp * g.rx + ix) * g.ry + iy) * g.words + (iz >> 5));
      shift[k][dp] = iz & 31;
    }
  }
#pragma unroll
  for (int k = 0; k < Q; ++k) {
    uint32_t h = 0;
#pragma unroll
    for (int dp = 0; dp <= kPad; ++dp) h |= word[k][dp] >> shift[k][dp];
    hit[k] = inside[k] ? (h & 1u) : 0u;
  }
}

template <int kPad>
__global__ void __launch_bounds__(kThreads)
    occ_query_kernel(const float* __restrict__ px, const float* __restrict__ py,
                     const float* __restrict__ pz, const float* __restrict__ aabb,
                     uint8_t* __restrict__ out, int64_t n, Grid g) {
  Box b;
  b.x0 = __ldg(aabb + 0), b.y0 = __ldg(aabb + 1), b.z0 = __ldg(aabb + 2);
  b.ex = __ldg(aabb + 3) - b.x0, b.ey = __ldg(aabb + 4) - b.y0, b.ez = __ldg(aabb + 5) - b.z0;
  const int64_t quads = n >> 2;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t q = first; q < quads; q += stride) {
    const float4 x4 = __ldg(reinterpret_cast<const float4*>(px) + q);
    const float4 y4 = __ldg(reinterpret_cast<const float4*>(py) + q);
    const float4 z4 = __ldg(reinterpret_cast<const float4*>(pz) + q);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    const float y[4] = {y4.x, y4.y, y4.z, y4.w};
    const float z[4] = {z4.x, z4.y, z4.z, z4.w};
    uint32_t hit[4];
    query<4, kPad>(x, y, z, b, g, hit);
    reinterpret_cast<uint32_t*>(out)[q] = hit[0] | hit[1] << 8 | hit[2] << 16 | hit[3] << 24;
  }
  // The last n % 4 queries, one a thread of the first block.
  if (first < (n & 3)) {
    const int64_t i = (quads << 2) + first;
    const float x[1] = {__ldg(px + i)}, y[1] = {__ldg(py + i)}, z[1] = {__ldg(pz + i)};
    uint32_t hit[1];
    query<1, kPad>(x, y, z, b, g, hit);
    out[i] = static_cast<uint8_t>(hit[0]);
  }
}

// Blocks of kThreads that fit on the card at once, for each kernel; found
// once per device.
template <int kPad>
int resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, occ_query_kernel<kPad>, kThreads, 0);
    cached[dev] = max(sms * per_sm, 1);
  }
  return cached[dev];
}

template <int kPad>
int launch(const float* px, const float* py, const float* pz, const float* aabb,
           uint8_t* out, long long n, const Grid& g, cudaStream_t stream) {
  const long long want = ((n >> 2) + kThreads - 1) / kThreads;
  const long long wave = resident_blocks<kPad>();
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < wave ? want : wave));
  occ_query_kernel<kPad><<<blocks, kThreads, 0, stream>>>(px, py, pz, aabb, out, n, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// px, py, pz: n float32 each, 16-byte aligned; packed: (levels, rx, ry,
// words) int32 words, fewer than 2^31, levels at most 126; aabb: the 6
// float32 of the level-0 box; out: n bytes, 4-byte aligned.
extern "C" int occ_query_launch(const float* px, const float* py,
                                const float* pz, const uint32_t* packed,
                                const float* aabb, uint8_t* out, long long n,
                                int levels, int rx, int ry, int rz, int words,
                                int mip_pad, void* stream) {
  if (n <= 0) return 0;
  const Grid g{packed, levels, rx, ry, rz, words};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return mip_pad ? launch<1>(px, py, pz, aabb, out, n, g, s)
                 : launch<0>(px, py, pz, aabb, out, n, g, s);
}
