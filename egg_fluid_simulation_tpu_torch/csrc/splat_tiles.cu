// Kernel G: slot-major per-tile gaussian splat.
//
// Replaces: egg_fluid_simulation_tpu/ops/pallas/splat_kernel.py
//           (splat_tiles / _make_kernel, the slot-major v1 splat).
//
// What it computes, per evaluation tile t (origin ((t / ntx) * th,
// (t % ntx) * tw) effective canvas pixels) and pixel centre (px, py) at
// +0.5:
//   alpha = 1 - prod (1 - g)
// over the candidates of the chunks c < trips[t] of cand (T, n_chunks, 9,
// 128); chunks past trips[t] are never read, whatever they hold. Per
// candidate (fields 0, 1, 2, 3, 6, 7, 8 = x, y, cos, sin, inv_sx, inv_sy,
// a):
//   dx = px - x, dy = py - y
//   nx = dx * (cos * inv_sx) + dy * (sin * inv_sx)
//   ny = dy * (cos * inv_sy) - dx * (sin * inv_sy)
//   g  = a * exp(-(4 pi / 3) (nx^2 + ny^2))
//        if max(|nx|, |ny|, max(|dx|, |dy|) / max_splat_px) <= 1, else 0
// This is the TPU kernel's normalised box test, not kernel C's extent test.
//
// Design: one block per tile, one thread per pixel (tiles up to 1024
// pixels). Per chunk, the block stages the chunk's candidates in shared
// memory with the per-candidate products (cos * inv_sx, sin * inv_sx,
// cos * inv_sy, sin * inv_sy) formed once there, not once per pixel; each
// thread then multiplies the 128 candidates into its running product in
// candidate order. The TPU kernel's tile groups and its per-lane products
// with a final 128-lane halving were TPU layout choices and are dropped:
// the products run in another order than the plain version's, so the two
// agree to rounding.
//
// Bound on the H100: expf and about 25 FP32 operations per candidate and
// pixel (at the 1M scene's render, several hundred candidates per pixel)
// against the bytes of cand (7 of its 9 fields, read once per tile). The
// operations bind: each staged candidate is reused by all th * tw pixels.
//
// Numerics: no --use_fast_math (expf stays the accurate one); the library
// is built with --fmad=false.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;
constexpr int kFields = 9;
constexpr float kGauss = 4.1887902047863905f;  // 4 pi / 3, particle_texture.glsl:8

__global__ void splat_tiles_kernel(const float* __restrict__ cand,
                                   const int* __restrict__ trips,
                                   float* __restrict__ out, int n_chunks,
                                   int th, int tw, int ntx, float icap) {
  // staged chunk: x, y, cos*isx, sin*isx, cos*isy, sin*isy, a
  __shared__ float s_x[kChunk], s_y[kChunk], s_cax[kChunk], s_sax[kChunk],
      s_cay[kChunk], s_say[kChunk], s_a[kChunk];
  const int t = blockIdx.x;
  const int npix = th * tw;
  const int p = threadIdx.x;
  const int y = p / tw;
  const int x = p - y * tw;
  const int ty = t / ntx;
  const int tx = t - ty * ntx;
  // pixel centres as the TPU kernel forms them: iota + 0.5, plus the origin
  const float px = (static_cast<float>(x) + 0.5f) + static_cast<float>(tx * tw);
  const float py = (static_cast<float>(y) + 0.5f) + static_cast<float>(ty * th);

  int n_run = trips[t];
  n_run = n_run < 0 ? 0 : (n_run > n_chunks ? n_chunks : n_run);
  float acc = 1.0f;
  const float* tile = cand + static_cast<long long>(t) * n_chunks * kFields * kChunk;
  for (int c = 0; c < n_run; ++c) {
    const float* ch = tile + static_cast<long long>(c) * kFields * kChunk;
    __syncthreads();  // the previous chunk's readers are done
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
      const float ca = ch[2 * kChunk + j], sa = ch[3 * kChunk + j];
      const float isx = ch[6 * kChunk + j], isy = ch[7 * kChunk + j];
      s_x[j] = ch[j];
      s_y[j] = ch[kChunk + j];
      s_cax[j] = ca * isx;
      s_sax[j] = sa * isx;
      s_cay[j] = ca * isy;
      s_say[j] = sa * isy;
      s_a[j] = ch[8 * kChunk + j];
    }
    __syncthreads();
    if (p < npix) {
      for (int j = 0; j < kChunk; ++j) {
        const float dx = px - s_x[j];
        const float dy = py - s_y[j];
        const float nx = dx * s_cax[j] + dy * s_sax[j];
        const float ny = dy * s_cay[j] - dx * s_say[j];
        const float r2 = nx * nx + ny * ny;
        const float m = fmaxf(fmaxf(fabsf(nx), fabsf(ny)),
                              icap * fmaxf(fabsf(dx), fabsf(dy)));
        const float g = m <= 1.0f ? expf(-kGauss * r2) * s_a[j] : 0.0f;
        acc = acc * (1.0f - g);  // screen blend
      }
    }
  }
  if (p < npix) {
    out[static_cast<long long>(t) * npix + p] = 1.0f - acc;
  }
}

}  // namespace

extern "C" int egg_splat_tiles(const float* cand, const int* trips,
                               float* out, int n_tiles, int n_chunks, int th,
                               int tw, int ntx, int max_splat_px,
                               cudaStream_t stream) {
  const int npix = th * tw;
  if (npix <= 0 || npix > 1024 || max_splat_px <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles == 0) return 0;
  const int threads = (npix + 31) / 32 * 32;
  // 1 / max_splat_px rounded once to float32, as the JAX kernel's constant
  const float icap = static_cast<float>(1.0 / static_cast<double>(max_splat_px));
  splat_tiles_kernel<<<n_tiles, threads, 0, stream>>>(cand, trips, out,
                                                      n_chunks, th, tw, ntx,
                                                      icap);
  return static_cast<int>(cudaGetLastError());
}
