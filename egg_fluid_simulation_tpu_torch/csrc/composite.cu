// Kernel I: the render's canvas-to-screen tail.
//
// Replaces: no TPU kernel. The JAX package leaves this work to XLA
// (egg_fluid_simulation_tpu/ops/render.py: _resize_linear_up, a bilinear
// upsample written as two interpolation-matrix products, then
// _paste_src_over_frac / _paste_src_over), which fuses the paste. In
// PyTorch the same sequence is two FP32 matrix products a canvas plus
// dozens of full-resolution elementwise launches (a padded canvas, four
// shifted views, a gathered viewport, a channel-by-channel blend, a cat):
// ops/kernels/composite_kernel.py keeps it as the plain version.
//
// Two entry points:
// - egg_composite: one launch a population. Per screen pixel (Y, X) of the
//   (vh, vw, 4) frame, with (x0, y0) = floor(corner) and (fx, fy) its
//   fractional part, the canvas pixel under it is (Y - y0, X - x0); the
//   shifted canvas there is
//     s00 (1-fx)(1-fy) + s01 fx (1-fy) + s10 (1-fx) fy + s11 fx fy,
//   s01 one canvas column to the left, s10 one row up, zero off the canvas,
//   each sample the bilinear upsample of the source RGBA to the canvas size
//   S evaluated at that canvas pixel; the result is blended src-over
//   (straight RGBA, alpha clamped to [0, 1]) onto the frame. Screen pixels
//   off the canvas keep the frame's value; with over_zero the destination
//   is taken as zero and never read (the first population), so every pixel
//   is written.
// - egg_upsample: the same bilinear taps for c channels into (S, S, c).
//
// The taps are _resize_matrix's: output index o samples
//   pos = (o + 0.5) * (s_in / s_out) - 0.5   (in double, as the matrix is
//   made), lo = floor(pos), w = float(pos - lo),
// weights 1 - w at clamp(lo) and w at clamp(lo + 1). Where the clamp lands
// both on one index the matrix holds the float32 sum of the two weights,
// and so does the single tap here (exactly 1.0 at factors 2 and 4). Rows
// first, then columns, as the two products order them; at s_in == s_out the
// value passes through, as _resize_linear_up returns its input. Against
// the matrices only the rounding differs: a product holds each tap's term
// and adds the two in one FMA chain, this library rounds each product
// (--fmad=false), about 1e-7 on values in [0, 1].
//
// Bound on the H100: bytes. A launch writes its output once (a 2560 px
// frame is 105 MB) and the yolk's reads the frame once more; the source
// (a 640 px RGBA canvas, 6.5 MB) stays in L2, and the up to 16 reads of it
// a pixel (four shift samples of two by two taps, mostly the same ones)
// hit L1. One thread a pixel, 16-byte loads and stores of RGBA: about 200
// float32 operations a pixel, a few microseconds of the card's FP32 rate at
// 6.5M pixels.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Taps {
  int lo, hi;     // source indices, clamped
  float w0, w1;   // their weights; w1 unused where merged
  bool merged;    // both taps on one index: one term of weight w0
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ Taps taps_of(int o, int s_in, int s_out) {
  const double pos =
      (static_cast<double>(o) + 0.5) *
          (static_cast<double>(s_in) / static_cast<double>(s_out)) -
      0.5;
  const double fl = floor(pos);
  const float w = static_cast<float>(pos - fl);
  const int lo = static_cast<int>(fl);
  Taps t;
  t.lo = clampi(lo, 0, s_in - 1);
  t.hi = clampi(lo + 1, 0, s_in - 1);
  t.w0 = 1.0f - w;
  t.w1 = w;
  t.merged = t.lo == t.hi;
  if (t.merged) t.w0 = t.w0 + t.w1;
  return t;
}

__device__ __forceinline__ float4 mul4(float4 a, float w) {
  return make_float4(a.x * w, a.y * w, a.z * w, a.w * w);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 ld4(const float4* p, long long i) {
  return __ldg(p + i);
}

// one RGBA value of the source upsampled to s_out at (r, c): rows first
__device__ __forceinline__ float4 up4(const float4* src, int s_in, int s_out,
                                      const Taps& tr, const Taps& tc, int r,
                                      int c) {
  if (s_in == s_out) return ld4(src, static_cast<long long>(r) * s_in + c);
  float4 at_lo, at_hi;  // the row pass at the two source columns
  const long long r0 = static_cast<long long>(tr.lo) * s_in;
  const long long r1 = static_cast<long long>(tr.hi) * s_in;
  if (tr.merged) {
    at_lo = mul4(ld4(src, r0 + tc.lo), tr.w0);
    at_hi = tc.merged ? at_lo : mul4(ld4(src, r0 + tc.hi), tr.w0);
  } else {
    at_lo = add4(mul4(ld4(src, r0 + tc.lo), tr.w0),
                 mul4(ld4(src, r1 + tc.lo), tr.w1));
    at_hi = tc.merged ? at_lo
                      : add4(mul4(ld4(src, r0 + tc.hi), tr.w0),
                             mul4(ld4(src, r1 + tc.hi), tr.w1));
  }
  if (tc.merged) return mul4(at_lo, tc.w0);
  return add4(mul4(at_lo, tc.w0), mul4(at_hi, tc.w1));
}

__global__ void __launch_bounds__(kThreads) composite_kernel(
    const float4* __restrict__ src, int s_in, int s, const float* corner,
    float4* frame, int vh, int vw, int over_zero) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= static_cast<long long>(vh) * vw) return;
  const int y = static_cast<int>(p / vw);
  const int x = static_cast<int>(p - static_cast<long long>(y) * vw);
  const float cx = corner[0], cy = corner[1];
  const float ix = floorf(cx), iy = floorf(cy);
  const float fx = cx - ix, fy = cy - iy;  // in [0, 1]
  // the canvas pixel under this screen pixel; far corners saturate and
  // land off the canvas either way
  const long long r = y - static_cast<long long>(iy);
  const long long c = x - static_cast<long long>(ix);
  const bool inside = r >= 0 && r < s && c >= 0 && c < s;
  if (!inside) {
    if (over_zero) frame[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;  // src-over a zero source leaves the frame as it is
  }
  const int ri = static_cast<int>(r), ci = static_cast<int>(c);
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const Taps tr = taps_of(ri, s_in, s);
  const Taps tc = taps_of(ci, s_in, s);
  const float4 s00 = up4(src, s_in, s, tr, tc, ri, ci);
  float4 s01 = zero, s10 = zero, s11 = zero;
  if (ci > 0 || ri > 0) {
    const Taps trm = ri > 0 ? taps_of(ri - 1, s_in, s) : tr;
    const Taps tcm = ci > 0 ? taps_of(ci - 1, s_in, s) : tc;
    if (ci > 0) s01 = up4(src, s_in, s, tr, tcm, ri, ci - 1);
    if (ri > 0) s10 = up4(src, s_in, s, trm, tc, ri - 1, ci);
    if (ci > 0 && ri > 0) s11 = up4(src, s_in, s, trm, tcm, ri - 1, ci - 1);
  }
  // _paste_src_over_frac's order: ((a + b) + c) + d, each term
  // (sample * wx) * wy
  const float ux = 1.0f - fx, uy = 1.0f - fy;
  const float4 shifted =
      add4(add4(add4(mul4(mul4(s00, ux), uy), mul4(mul4(s01, fx), uy)),
                mul4(mul4(s10, ux), fy)),
           mul4(mul4(s11, fx), fy));
  const float a = fminf(fmaxf(shifted.w, 0.0f), 1.0f);
  const float keep = 1.0f - a;
  const float4 dst = over_zero ? zero : frame[p];
  frame[p] = make_float4(shifted.x * a + dst.x * keep,
                         shifted.y * a + dst.y * keep,
                         shifted.z * a + dst.z * keep, a + dst.w * keep);
}

__global__ void __launch_bounds__(kThreads) upsample_kernel(
    const float* __restrict__ src, int s_in, int s_out, int channels,
    float* __restrict__ out) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (p >= static_cast<long long>(s_out) * s_out) return;
  const int r = static_cast<int>(p / s_out);
  const int c = static_cast<int>(p - static_cast<long long>(r) * s_out);
  const Taps tr = taps_of(r, s_in, s_out);
  const Taps tc = taps_of(c, s_in, s_out);
  const long long r0 = static_cast<long long>(tr.lo) * s_in;
  const long long r1 = static_cast<long long>(tr.hi) * s_in;
  for (int k = 0; k < channels; ++k) {
    auto at = [&](long long row, int col) {
      return __ldg(src + (row + col) * channels + k);
    };
    float v_lo, v_hi;  // the row pass at the two source columns
    if (tr.merged) {
      v_lo = at(r0, tc.lo) * tr.w0;
      v_hi = tc.merged ? v_lo : at(r0, tc.hi) * tr.w0;
    } else {
      v_lo = at(r0, tc.lo) * tr.w0 + at(r1, tc.lo) * tr.w1;
      v_hi = tc.merged ? v_lo : at(r0, tc.hi) * tr.w0 + at(r1, tc.hi) * tr.w1;
    }
    out[p * channels + k] =
        tc.merged ? v_lo * tc.w0 : v_lo * tc.w0 + v_hi * tc.w1;
  }
}

int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int egg_composite(const float* src, const float* corner,
                             float* frame, int s_in, int s, int vh, int vw,
                             int over_zero, cudaStream_t stream) {
  if (s_in <= 0 || s < s_in || vh <= 0 || vw <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  composite_kernel<<<blocks_for(static_cast<long long>(vh) * vw), kThreads, 0,
                     stream>>>(reinterpret_cast<const float4*>(src), s_in, s,
                               corner, reinterpret_cast<float4*>(frame), vh,
                               vw, over_zero);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int egg_upsample(const float* src, float* out, int s_in, int s_out,
                            int channels, cudaStream_t stream) {
  if (s_in <= 0 || s_out < s_in || channels < 1 || channels > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  upsample_kernel<<<blocks_for(static_cast<long long>(s_out) * s_out),
                    kThreads, 0, stream>>>(src, s_in, s_out, channels, out);
  return static_cast<int>(cudaGetLastError());
}
