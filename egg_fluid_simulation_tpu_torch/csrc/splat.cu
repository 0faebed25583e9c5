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
// max_splat_px. With RGB it also forms prod_i (1 - g_i * rgb_i) per channel.
// Per candidate and pixel the arithmetic is the plain scan's of
// ops/kernels/splat_kernel.splat_plain term for term; only the order of the
// product differs (raster bin order here, 128-candidate chunk products
// there), so results agree to rounding.
//
// Inputs come straight from the bin-resident payload (n_bins + 1, K, F) and
// the per-bin counts: there is no pre-gathered candidate tensor. Only the
// first min(counts[b], K) slots of a bin are read (an overflowed bin has
// counts > K). Every window position is a real bin of the ring-extended bin
// grid, so the payload's last row, which holds nothing, is never read.
//
// Design. One block per evaluation tile, one pixel a thread up to 256
// pixels a tile (an 8 x 16 tile is a block of four warps), 2, 4 or 8 pixels
// a thread above that (256 threads at most, 2048 pixels a tile); a thread
// keeps its pixels' products in registers. The block's first warp walks the
// window's bins in raster order, 32 slots of one bin a step, and compacts
// the candidates that can reach the tile into a shared-memory buffer of 128
// candidates (three float4 a candidate: 6 KB, whatever K is), one barrier
// pair per buffer-full instead of one per bin:
// - the cull: a candidate's footprint lies inside the box of half-extents
//     ex = min((|cos| e_par + |sin| e_perp) / (cos^2 + sin^2), max_splat_px)
//     ey = min((|sin| e_par + |cos| e_perp) / (cos^2 + sin^2), max_splat_px)
//   around its centre (the rotated quad's bounding box, cut by the static
//   cap), widened by 0.1% + 0.01 px against rounding. Where that box misses
//   the rectangle of the tile's pixel centres, `inside` is false at every
//   pixel of the tile, g is 0 and the factor is exactly 1.0: dropping the
//   candidate changes no bit. Survivors keep their raster order.
//   ops/kernels/splat_kernel.cull_counts is the same test in PyTorch.
// Then every thread multiplies the buffered candidates into its pixels: a
// candidate's 9 (12) fields are three broadcast 16-byte loads; the extent
// test comes before the normalisation and the expf. RGB is a template
// argument.
//
// Bound on the H100: instructions, and the warps in flight. A candidate at a
// pixel costs about 33 (three loads, the rotation, four compares, the
// accurate expf, the blend) under --fmad=false; the payload a block reads
// is a few tens of KB, and staging alone is a sixth of a launch. The 1M
// scene's 640 x 640 canvas has only 3200 tiles, so the pixels a thread
// decide how many warps an SM has to hide latency with: 1 pixel a thread
// measured fastest (2 and 4 a thread 11% and 22% slower at 8 x 16 tiles).
// Every white quad there has the extent max_splat_px, so the cull keeps 63%
// of the window's candidates, and 48% of a staged candidate's pixels lie
// inside its quad: the tile-wide cull leaves half the evaluations to
// factors of 1.0.
//
// Ablation builds, used by profile_torch_sweeps.py only:
// -DEGG_SPLAT_NO_CULL stages every occupied window candidate;
// -DEGG_SPLAT_NO_EVAL stages and multiplies nothing (wrong output). Tried
// and not kept: a warp vote (__any_sync) that skips a candidate where none
// of the warp's 32 pixels passes the extent test measured 1-4% slower at
// the 1M scene's geometry.
//
// Numerics: no --use_fast_math (expf stays the accurate one), and the
// library is built with --fmad=false so each product and sum rounds as in
// the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxPixelsPerThread = 8;
constexpr int kBuffer = 128;  // candidates staged per barrier pair
constexpr float kGauss = 4.1887902047863905f;  // 4 pi / 3, particle_texture.glsl:8

#ifdef EGG_SPLAT_NO_CULL
constexpr bool kCull = false;
#else
constexpr bool kCull = true;
#endif
#ifdef EGG_SPLAT_NO_EVAL
constexpr bool kEval = false;
#else
constexpr bool kEval = true;
#endif

struct Window {
  int by0, bx0, nbx, wy, wx, k, n_f;
  float x_lo, x_hi, y_lo, y_hi;  // the tile's first and last pixel centres
  float max_splat;
};

// The first warp's walk over the window's bins: from cursor (wi, s0) on, 32
// slots of one bin a step, the candidates whose box reaches the tile
// appended to `buf` in raster order until the buffer may overflow or the
// window ends. Returns the number staged; *done is set at the window's end.
template <bool RGB>
__device__ __forceinline__ int stage_candidates(
    const float* __restrict__ payload, const int* __restrict__ counts,
    const Window& w, int* wi, int* s0, float4* buf, bool* done) {
  const unsigned lane = threadIdx.x & 31u;
  const int n_win = w.wy * w.wx;
  int n = 0;
  while (*wi < n_win && n + 32 <= kBuffer) {
    const int wrow = *wi / w.wx;
    const int b = (w.by0 + wrow) * w.nbx + w.bx0 + (*wi - wrow * w.wx);
    const int cnt = min(counts[b], w.k);
    if (*s0 >= cnt) {  // the same for every lane
      ++*wi;
      *s0 = 0;
      continue;
    }
    const int slot = *s0 + static_cast<int>(lane);
    *s0 += 32;
    float4 c0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c1 = c0, c2 = c0;
    bool keep = slot < cnt;
    if (keep) {
      const float* c =
          payload + (static_cast<long long>(b) * w.k + slot) * w.n_f;
      c0 = make_float4(c[0], c[1], c[2], c[3]);  // x, y, cos, sin
      c1 = make_float4(c[4], c[5], c[6], c[7]);  // e_perp, e_par, 1/sx, 1/sy
      c2.x = c[8];                               // a
      if (RGB) {
        c2.y = c[9];
        c2.z = c[10];
        c2.w = c[11];
      }
      if (kCull) {
        const float ac = fabsf(c0.z), as = fabsf(c0.w);
        const float n2 = c0.z * c0.z + c0.w * c0.w;
        // fminf drops a NaN (a zero direction): the static cap then holds
        const float ex =
            fminf((ac * c1.y + as * c1.x) / n2 * 1.001f, w.max_splat) + 0.01f;
        const float ey =
            fminf((as * c1.y + ac * c1.x) / n2 * 1.001f, w.max_splat) + 0.01f;
        keep = c0.x >= w.x_lo - ex && c0.x <= w.x_hi + ex &&
               c0.y >= w.y_lo - ey && c0.y <= w.y_hi + ey;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (keep) {
      float4* dst = buf + 3 * (n + __popc(ballot & ((1u << lane) - 1u)));
      dst[0] = c0;
      dst[1] = c1;
      dst[2] = c2;
    }
    n += __popc(ballot);
  }
  *done = *wi >= n_win;
  return n;
}

template <int PPT, bool RGB>
__global__ void __launch_bounds__(kMaxThreads) splat_kernel(
    const float* __restrict__ payload, const int* __restrict__ counts,
    float* __restrict__ alpha, float* __restrict__ rgb, int s, int th, int tw,
    int bh, int bw, int nbx, int wy, int wx, int k, int n_f,
    float max_splat) {
  __shared__ float4 buf[3 * kBuffer];
  __shared__ int s_n;
  __shared__ bool s_done;
  const int ntx = s / tw;
  const int ty = blockIdx.x / ntx;
  const int tx = blockIdx.x - ty * ntx;
  const int npix = th * tw;

  float px[PPT], py[PPT], acc[PPT];
  float acc_r[RGB ? PPT : 1], acc_g[RGB ? PPT : 1], acc_b[RGB ? PPT : 1];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    const int y = p / tw;
    const int x = p - y * tw;
    // pixel centres in effective canvas pixels, as the plain scan forms them
    px[i] = (static_cast<float>(x) + 0.5f) + static_cast<float>(tx * tw);
    py[i] = (static_cast<float>(y) + 0.5f) + static_cast<float>(ty * th);
    acc[i] = 1.0f;
    if (RGB) acc_r[i] = acc_g[i] = acc_b[i] = 1.0f;
  }

  Window w;
  w.by0 = ty * (th / bh);
  w.bx0 = tx * (tw / bw);
  w.nbx = nbx;
  w.wy = wy;
  w.wx = wx;
  w.k = k;
  w.n_f = n_f;
  w.x_lo = 0.5f + static_cast<float>(tx * tw);
  w.x_hi = (static_cast<float>(tw - 1) + 0.5f) + static_cast<float>(tx * tw);
  w.y_lo = 0.5f + static_cast<float>(ty * th);
  w.y_hi = (static_cast<float>(th - 1) + 0.5f) + static_cast<float>(ty * th);
  w.max_splat = max_splat;
  int wi = 0, s0 = 0;  // the staging warp's cursor

  for (;;) {
    if (threadIdx.x < 32) {
      bool done;
      const int n = stage_candidates<RGB>(payload, counts, w, &wi, &s0, buf,
                                          &done);
      if (threadIdx.x == 0) {
        s_n = n;
        s_done = done;
      }
    }
    __syncthreads();
    const int n = s_n;
    const bool done = s_done;
    for (int j = 0; j < (kEval ? n : 0); ++j) {
      const float4 c0 = buf[3 * j], c1 = buf[3 * j + 1], c2 = buf[3 * j + 2];
      const float pcx = c0.x, pcy = c0.y, ca = c0.z, sa = c0.w;
      const float bs = c1.x, bs_sm = c1.y, isx = c1.z, isy = c1.w;
      const float ap = c2.x;
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        const float dx = px[i] - pcx;
        const float dy = py[i] - pcy;
        // rotate into the velocity frame (instanced_draw.glsl:27-35)
        const float d_par = dx * ca + dy * sa;
        const float d_perp = -dx * sa + dy * ca;
        const bool inside = fabsf(d_par) <= bs_sm && fabsf(d_perp) <= bs &&
                            fabsf(dx) <= max_splat && fabsf(dy) <= max_splat;
        const float nx = d_par * isx;
        const float ny = d_perp * isy;
        const float r2 = nx * nx + ny * ny;
        const float gv = inside ? expf(-kGauss * r2) * ap : 0.0f;
        acc[i] = acc[i] * (1.0f - gv);  // screen blend
        if (RGB) {
          acc_r[i] = acc_r[i] * (1.0f - gv * c2.y);
          acc_g[i] = acc_g[i] * (1.0f - gv * c2.z);
          acc_b[i] = acc_b[i] * (1.0f - gv * c2.w);
        }
      }
    }
    if (done) break;
    __syncthreads();  // the buffer's readers are done
  }

#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int p = threadIdx.x + i * blockDim.x;
    if (p >= npix) break;
    const int y = p / tw;
    const int x = p - y * tw;
    const long long o = static_cast<long long>(ty * th + y) * s + tx * tw + x;
    alpha[o] = 1.0f - acc[i];
    if (RGB) {
      rgb[3 * o] = 1.0f - acc_r[i];
      rgb[3 * o + 1] = 1.0f - acc_g[i];
      rgb[3 * o + 2] = 1.0f - acc_b[i];
    }
  }
}

template <int PPT>
cudaError_t launch(const float* payload, const int* counts, float* alpha,
                   float* rgb, int s, int th, int tw, int bh, int bw, int nbx,
                   int wy, int wx, int k, int n_f, float max_splat,
                   int use_rgb, cudaStream_t stream) {
  const int npix = th * tw;
  const int threads = ((npix + PPT - 1) / PPT + 31) / 32 * 32;
  const int n_tiles = (s / th) * (s / tw);
  if (use_rgb)
    splat_kernel<PPT, true><<<n_tiles, threads, 0, stream>>>(
        payload, counts, alpha, rgb, s, th, tw, bh, bw, nbx, wy, wx, k, n_f,
        max_splat);
  else
    splat_kernel<PPT, false><<<n_tiles, threads, 0, stream>>>(
        payload, counts, alpha, rgb, s, th, tw, bh, bw, nbx, wy, wx, k, n_f,
        max_splat);
  return cudaGetLastError();
}

}  // namespace

extern "C" int egg_splat(const float* payload, const int* counts,
                         float* alpha, float* rgb, int s, int th, int tw,
                         int bh, int bw, int nbx, int wy, int wx, int k,
                         int n_f, int max_splat_px, int use_rgb,
                         cudaStream_t stream) {
  const int npix = th * tw;
  if (npix <= 0 || npix > kMaxThreads * kMaxPixelsPerThread ||
      n_f < (use_rgb ? 12 : 9)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  // pixels a thread: 1, doubled until the tile fits 256 threads
  int ppt = 1;
  while (ppt < kMaxPixelsPerThread && (npix + ppt - 1) / ppt > kMaxThreads)
    ppt *= 2;
  const float msp = static_cast<float>(max_splat_px);
  cudaError_t err;
  switch (ppt) {
    case 1:
      err = launch<1>(payload, counts, alpha, rgb, s, th, tw, bh, bw, nbx, wy,
                      wx, k, n_f, msp, use_rgb, stream);
      break;
    case 2:
      err = launch<2>(payload, counts, alpha, rgb, s, th, tw, bh, bw, nbx, wy,
                      wx, k, n_f, msp, use_rgb, stream);
      break;
    case 4:
      err = launch<4>(payload, counts, alpha, rgb, s, th, tw, bh, bw, nbx, wy,
                      wx, k, n_f, msp, use_rgb, stream);
      break;
    default:
      err = launch<8>(payload, counts, alpha, rgb, s, th, tw, bh, bw, nbx, wy,
                      wx, k, n_f, msp, use_rgb, stream);
  }
  return static_cast<int>(err);
}
