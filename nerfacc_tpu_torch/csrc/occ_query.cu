// Occupancy query: is the cell containing each point occupied?
//
// Replaces the TPU kernel nerfacc_tpu/ops/occ_query.py:occupancy_query_pallas
// (kernel body _query_kernel), and computes the multi-level semantics of
// nerfacc_tpu/grid.py:_query_soa in one launch for all levels, with the same
// float arithmetic: division by the box extent, frexpf for the mip level, an
// exact power of two for the level scale, truncation toward zero, then the
// clamp.  Built with --fmad=false, so no multiply-add is contracted and a
// point on a cell face lands in the same cell as in the plain PyTorch version
// (nerfacc_tpu_torch/ops/occ_query.py:occupancy_query_plain).
//
// Grid layout: (levels, rx, ry, words) 32-bit words, bit b of word
// [l, ix, iy, w] is cell (l, ix, iy, 32 * w + b).
//
// What bounds it: device memory.  Each query reads three f32 coordinates and
// writes one byte, about 13 B; it does some 30 float operations, far below
// the card's rate.  The TPU kernel kept the grid in VMEM; here a 128^3 level
// is 256 KB of bits, more than one SM's 227 KB of shared memory, but it stays
// resident in the 50 MB L2, so the word reads go through __ldg to L2 and the
// kernel streams the coordinates once.  One thread per query, no shared
// memory, no atomics.

#include <stdint.h>

#include "common.cuh"

namespace {

__global__ void occ_query_kernel(const float* __restrict__ px,
                                 const float* __restrict__ py,
                                 const float* __restrict__ pz,
                                 const uint32_t* __restrict__ packed,
                                 const float* __restrict__ aabb,
                                 uint8_t* __restrict__ out, int64_t n,
                                 int levels, int rx, int ry, int rz, int words,
                                 int mip_pad) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const float x0 = __ldg(aabb + 0), y0 = __ldg(aabb + 1), z0 = __ldg(aabb + 2);
  const float ex = __ldg(aabb + 3) - x0;
  const float ey = __ldg(aabb + 4) - y0;
  const float ez = __ldg(aabb + 5) - z0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float nx = (__ldg(px + i) - x0) / ex - 0.5f;
    const float ny = (__ldg(py + i) - y0) / ey - 0.5f;
    const float nz = (__ldg(pz + i) - z0) / ez - 0.5f;
    float m = fmaxf(fmaxf(fabsf(nx), fabsf(ny)), fabsf(nz));
    m = fmaxf(m, 0.1f);  // frexp of ~0 has exponent 0; clamp as the reference
    int e;
    frexpf(m, &e);
    const int mip = max(e + 1, 0);
    uint32_t hit = 0;
    if (mip < levels) {  // the selector: inside the outermost level
      for (int dp = 0; dp <= mip_pad; ++dp) {
        const int mp = min(mip + dp, levels - 1);
        const float s = ldexpf(1.0f, -mp);  // exact 2^-mp
        const int ix = min(max(static_cast<int>((nx * s + 0.5f) * rx), 0), rx - 1);
        const int iy = min(max(static_cast<int>((ny * s + 0.5f) * ry), 0), ry - 1);
        const int iz = min(max(static_cast<int>((nz * s + 0.5f) * rz), 0), rz - 1);
        const int64_t word =
            ((static_cast<int64_t>(mp) * rx + ix) * ry + iy) * words + (iz >> 5);
        hit |= (__ldg(packed + word) >> (iz & 31)) & 1u;
      }
    }
    out[i] = static_cast<uint8_t>(hit);
  }
}

}  // namespace

extern "C" int occ_query_launch(const float* px, const float* py,
                                const float* pz, const uint32_t* packed,
                                const float* aabb, uint8_t* out, long long n,
                                int levels, int rx, int ry, int rz, int words,
                                int mip_pad, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = static_cast<int>(want < (1LL << 30) ? want : (1LL << 30));
  occ_query_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, packed, aabb, out, n, levels, rx, ry, rz, words, mip_pad);
  return static_cast<int>(cudaGetLastError());
}
