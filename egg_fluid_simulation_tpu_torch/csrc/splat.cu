// Kernel C: per-tile gaussian splat accumulation of the render.
//
// Replaces: egg_fluid_simulation_tpu/ops/pallas/splat_kernel.py
//           (splat_rows / _make_kernel_rows, and splat_tiles_v2 /
//           _make_kernel_v2). The two TPU kernels differ only in how TPU
//           memory was laid out (a row slab, or a pre-gathered window); one
//           kernel serves both cases here.
//
// What it computes, per pixel of the (s, s) effective canvas:
//   alpha = 1 - prod_i (1 - g_i),  g_i = a_i * exp(-(4 pi / 3) * r_i^2)
// over the candidates of the pixel's evaluation tile: every particle binned
// into the tile's window of render bins (ops/render._tile_bins geometry).
// r_i is the pixel's distance in the particle's velocity-rotated frame,
// normalized by its quad extents; g_i is 0 outside the quad extent or past
// max_splat_px. With use_rgb it also forms prod_i (1 - g_i * rgb_i) per
// channel. The math is the plain scan of ops/render.splat_population term
// for term; only the order of the product differs (raster bin order here,
// 128-candidate chunk products there), so results agree to rounding.
//
// Inputs come straight from the bin-resident payload (n_bins + 1, K, F) and
// the per-bin counts: there is no pre-gathered candidate tensor and no
// 128-lane padding. One thread block per evaluation tile; each thread owns
// up to 8 pixels of the tile and keeps their products in registers. The
// block walks its window bins in raster order, skips empty ones (the TPU
// kernels' per-tile trip bound), stages each bin's candidates in shared
// memory, and every thread multiplies them into its pixels; 1 - prod is
// written once, directly in canvas layout.
//
// Bound on the H100: exp and the per-candidate arithmetic (about 25 flops
// per pixel and candidate, several hundred candidates per pixel at the 1M
// scene); the payload a block reads is a few tens of KB and is reused by
// all of the tile's pixels from shared memory.
//
// Numerics: no --use_fast_math (expf stays the accurate one), and the
// library is built with --fmad=false so each product and sum rounds as in
// the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxPixelsPerThread = 8;
constexpr float kGauss = 4.1887902047863905f;  // 4 pi / 3, particle_texture.glsl:8

__global__ void splat_kernel(const float* __restrict__ payload,
                             const int* __restrict__ counts,
                             float* __restrict__ alpha,
                             float* __restrict__ rgb, int s, int th, int tw,
                             int bh, int bw, int nbx, int wy, int wx, int k,
                             int n_f, float max_splat, int use_rgb,
                             int pix_per_thread) {
  extern __shared__ float cand[];  // one bin: k * n_f floats
  const int ntx = s / tw;
  const int ty = blockIdx.x / ntx;
  const int tx = blockIdx.x - ty * ntx;
  const int npix = th * tw;

  float px[kMaxPixelsPerThread], py[kMaxPixelsPerThread];
  float acc[kMaxPixelsPerThread], acc_r[kMaxPixelsPerThread],
      acc_g[kMaxPixelsPerThread], acc_b[kMaxPixelsPerThread];
#pragma unroll
  for (int i = 0; i < kMaxPixelsPerThread; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    const int y = p / tw;
    const int x = p - y * tw;
    // pixel centres in effective canvas pixels, as the plain scan forms them
    px[i] = (static_cast<float>(x) + 0.5f) + static_cast<float>(tx * tw);
    py[i] = (static_cast<float>(y) + 0.5f) + static_cast<float>(ty * th);
    acc[i] = 1.0f;
    acc_r[i] = 1.0f;
    acc_g[i] = 1.0f;
    acc_b[i] = 1.0f;
  }

  const int by0 = ty * (th / bh);
  const int bx0 = tx * (tw / bw);
  for (int wyi = 0; wyi < wy; ++wyi) {
    for (int wxi = 0; wxi < wx; ++wxi) {
      const int b = (by0 + wyi) * nbx + (bx0 + wxi);
      const int cnt = min(counts[b], k);
      if (cnt <= 0) continue;  // the same for every thread of the block
      __syncthreads();         // the previous bin's readers are done
      const float* src = payload + static_cast<long long>(b) * k * n_f;
      for (int t = threadIdx.x; t < cnt * n_f; t += blockDim.x) cand[t] = src[t];
      __syncthreads();
      for (int j = 0; j < cnt; ++j) {
        const float* c = cand + j * n_f;
        const float pcx = c[0], pcy = c[1], ca = c[2], sa = c[3];
        const float bs = c[4], bs_sm = c[5], isx = c[6], isy = c[7];
        const float ap = c[8];
#pragma unroll
        for (int i = 0; i < kMaxPixelsPerThread; ++i) {
          if (i >= pix_per_thread) break;
          const float dx = px[i] - pcx;
          const float dy = py[i] - pcy;
          // rotate into the velocity frame (instanced_draw.glsl:27-35)
          const float d_par = dx * ca + dy * sa;
          const float d_perp = -dx * sa + dy * ca;
          const float nx = d_par * isx;
          const float ny = d_perp * isy;
          const float r2 = nx * nx + ny * ny;
          const bool inside = fabsf(d_par) <= bs_sm && fabsf(d_perp) <= bs &&
                              fabsf(dx) <= max_splat && fabsf(dy) <= max_splat;
          const float gv = inside ? expf(-kGauss * r2) * ap : 0.0f;
          acc[i] = acc[i] * (1.0f - gv);  // screen blend
          if (use_rgb) {
            acc_r[i] = acc_r[i] * (1.0f - gv * c[9]);
            acc_g[i] = acc_g[i] * (1.0f - gv * c[10]);
            acc_b[i] = acc_b[i] * (1.0f - gv * c[11]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxPixelsPerThread; ++i) {
    if (i >= pix_per_thread) break;
    const int p = threadIdx.x + i * blockDim.x;
    if (p >= npix) break;
    const int y = p / tw;
    const int x = p - y * tw;
    const long long o = static_cast<long long>(ty * th + y) * s + tx * tw + x;
    alpha[o] = 1.0f - acc[i];
    if (use_rgb) {
      rgb[3 * o] = 1.0f - acc_r[i];
      rgb[3 * o + 1] = 1.0f - acc_g[i];
      rgb[3 * o + 2] = 1.0f - acc_b[i];
    }
  }
}

}  // namespace

extern "C" int egg_splat(const float* payload, const int* counts,
                         float* alpha, float* rgb, int s, int th, int tw,
                         int bh, int bw, int nbx, int wy, int wx, int k,
                         int n_f, int max_splat_px, int use_rgb,
                         cudaStream_t stream) {
  const int npix = th * tw;
  int threads = npix < 256 ? npix : 256;
  threads = (threads + 31) / 32 * 32;
  const int pix_per_thread = (npix + threads - 1) / threads;
  if (pix_per_thread > kMaxPixelsPerThread) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int n_tiles = (s / th) * (s / tw);
  const size_t smem = static_cast<size_t>(k) * n_f * sizeof(float);
  splat_kernel<<<n_tiles, threads, smem, stream>>>(
      payload, counts, alpha, rgb, s, th, tw, bh, bw, nbx, wy, wx, k, n_f,
      static_cast<float>(max_splat_px), use_rgb, pix_per_thread);
  return static_cast<int>(cudaGetLastError());
}
