// rayforge: the host-side ray sampler of the port's dataset loaders.
//
// The port's own copy of native/rayforge.cpp:1-143 (the JAX package's
// native input pipeline): pixel sampling, RGBA compositing over the
// background and ray generation in one OpenMP pass over the batch, with
// the same splitmix64 draws, so both packages give the same batches for a
// seed.  The loaders take it for training batches over images
// (datasets/nerf_synthetic.py).
//
// Plain C interface for ctypes.  Built by ops/_build.py at first use
// (g++ -O3 -fopenmp -shared -fPIC).

#include <cstdint>
#include <cmath>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// splitmix64: tiny, statistically solid per-ray seeding.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ull;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
  return x ^ (x >> 31);
}

static inline float uniform01(uint64_t bits) {
  // top 24 bits -> [0, 1)
  return (float)(bits >> 40) * (1.0f / 16777216.0f);
}

}  // namespace

extern "C" {

// Sample a training ray batch.
//
// images : (n_imgs, h, w, c) uint8, c in {3, 4}
// c2w    : (n_imgs, 12) float32 row-major 3x4 camera-to-world
// K      : (9,) float32 intrinsics
// bkgd   : (3,) float32 background color for RGBA compositing
// outputs: origins (n_rays, 3), viewdirs (n_rays, 3), pixels (n_rays, 3)
// opengl : 1 -> OpenGL convention (-z forward), 0 -> OpenCV (+z)
void rayforge_sample_rays(
    const uint8_t* images, int64_t n_imgs, int64_t h, int64_t w, int64_t c,
    const float* c2w, const float* K, const float* bkgd, uint64_t seed,
    int64_t n_rays, int opengl,
    float* out_o, float* out_d, float* out_pix) {
  const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];
  const float sign = opengl ? -1.0f : 1.0f;
  const int64_t img_stride = h * w * c;

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n_rays; ++i) {
    uint64_t s0 = splitmix64(seed ^ (uint64_t)i * 0x9e3779b97f4a7c15ull);
    uint64_t s1 = splitmix64(s0);
    uint64_t s2 = splitmix64(s1);

    const int64_t img = (int64_t)(s0 % (uint64_t)n_imgs);
    const int64_t px = (int64_t)(s1 % (uint64_t)w);
    const int64_t py = (int64_t)(s2 % (uint64_t)h);

    // pixel value, composited over bkgd when alpha present
    const uint8_t* p = images + img * img_stride + (py * w + px) * c;
    float r = p[0] * (1.0f / 255.0f);
    float g = p[1] * (1.0f / 255.0f);
    float b = p[2] * (1.0f / 255.0f);
    if (c == 4) {
      const float a = p[3] * (1.0f / 255.0f);
      r = r * a + bkgd[0] * (1.0f - a);
      g = g * a + bkgd[1] * (1.0f - a);
      b = b * a + bkgd[2] * (1.0f - a);
    }
    out_pix[i * 3 + 0] = r;
    out_pix[i * 3 + 1] = g;
    out_pix[i * 3 + 2] = b;

    // camera-space direction at pixel center
    const float dx = ((float)px + 0.5f - cx) / fx;
    const float dy = ((float)py + 0.5f - cy) / fy * sign;
    const float dz = sign;

    const float* m = c2w + img * 12;  // 3x4 row-major
    float wx = m[0] * dx + m[1] * dy + m[2] * dz;
    float wy = m[4] * dx + m[5] * dy + m[6] * dz;
    float wz = m[8] * dx + m[9] * dy + m[10] * dz;
    const float inv = 1.0f / std::sqrt(wx * wx + wy * wy + wz * wz);
    out_d[i * 3 + 0] = wx * inv;
    out_d[i * 3 + 1] = wy * inv;
    out_d[i * 3 + 2] = wz * inv;
    out_o[i * 3 + 0] = m[3];
    out_o[i * 3 + 1] = m[7];
    out_o[i * 3 + 2] = m[11];
  }
}

// Full-image eval rays for one pose (row-major pixel order).
void rayforge_image_rays(
    int64_t h, int64_t w, const float* c2w /* (12,) */, const float* K,
    int opengl, float* out_o, float* out_d) {
  const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];
  const float sign = opengl ? -1.0f : 1.0f;
  const float* m = c2w;

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t py = 0; py < h; ++py) {
    for (int64_t px = 0; px < w; ++px) {
      const int64_t i = py * w + px;
      const float dx = ((float)px + 0.5f - cx) / fx;
      const float dy = ((float)py + 0.5f - cy) / fy * sign;
      const float dz = sign;
      float wx = m[0] * dx + m[1] * dy + m[2] * dz;
      float wy = m[4] * dx + m[5] * dy + m[6] * dz;
      float wz = m[8] * dx + m[9] * dy + m[10] * dz;
      const float inv = 1.0f / std::sqrt(wx * wx + wy * wy + wz * wz);
      out_d[i * 3 + 0] = wx * inv;
      out_d[i * 3 + 1] = wy * inv;
      out_d[i * 3 + 2] = wz * inv;
      out_o[i * 3 + 0] = m[3];
      out_o[i * 3 + 1] = m[7];
      out_o[i * 3 + 2] = m[11];
    }
  }
}

int rayforge_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
