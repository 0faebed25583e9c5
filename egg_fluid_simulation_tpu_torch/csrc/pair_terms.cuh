// Pair math shared by the dense engine's sweep kernels (B, D, E, F).
//
// The device counterparts of the JAX package's _pair_terms helpers
// (egg_fluid_simulation_tpu/ops/pallas/sweep_kernel.py) and of the plain
// PyTorch versions in ops/kernels/sweep_kernel.py. Every operation is written
// in the plain version's order; the library builds with --fmad=false and
// without --use_fast_math, so each multiply, add, rsqrtf and '/' rounds on
// its own, as the plain version's separate elementwise ops do.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace egg {

constexpr float kEps = 1e-8f;        // utils.mathx.EPS as float32
constexpr float kEps2 = 1e-16f;      // EPS * EPS rounded once to float32
constexpr float kTieX = 0.5403023f;  // ops.dense.TIE_X
constexpr float kTieY = 0.8414710f;  // ops.dense.TIE_Y
constexpr int kRowPad = 8;           // ops.dense.ROW_PAD

// field rows of the (8, G + 2*ROW_PAD, L) planes (ops.dense.FIELD_*)
enum Field { kX = 0, kY, kW, kR, kBatch, kCum, kIdx, kOcc };

// jnp.mod / torch.remainder for floats: fmod, then the divisor's sign
__device__ __forceinline__ float mod_floor(float a, float m) {
  float r = fmodf(a, m);
  if (r != 0.0f && ((r < 0.0f) != (m < 0.0f))) r += m;
  return r;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  if ((a % b != 0) && ((a < 0) != (b < 0))) --q;
  return q;
}

// i in [-n, 2n) -> i mod n
__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// dense.lane_mask: the cells of lanes l and l - d are within +-w columns
__device__ __forceinline__ bool lane_ok(int s_lane, int d, int k, int w) {
  const int cell_diff = -floor_div(s_lane - d, k);
  return cell_diff <= w && cell_diff >= -w;
}

__device__ __forceinline__ bool torus_adjacent(float a, float b, float fm) {
  const float half = 0.5f * fm;
  const float dd = mod_floor(a - b + half, fm) - half;
  return fabsf(dd) <= 1.0f;
}

// fresh torus cell of a coordinate (the wide sweep's pair mask)
__device__ __forceinline__ float fresh_cell(float x, float cell_size,
                                            float fm) {
  return mod_floor(floorf(x / cell_size), fm);
}

struct PairConsts {
  float collision_c, cohesion_c, overlap_f, cohesion_f;
};

__device__ __forceinline__ PairConsts pair_consts(const float* params) {
  return PairConsts{params[0], params[1], params[2], params[3]};
}

// The trimmed XPBD projection of _pair_terms: the shared-divide factor
// num / den of one valid pair (0 where neither constraint fires, decided
// before the rsqrtf and the divide). `deg` (coincident pair) is
// dist2 <= kEps2; the caller picks the direction.
__device__ __forceinline__ float pair_ratio(float dist2, float sw, float ow,
                                            float sr, float orr, float sb,
                                            float ob, bool cohesion,
                                            const PairConsts& c) {
  const float w_sum = sw + ow;
  const bool ok = w_sum >= kEps;
  const float sum_r = sr + orr;
  const float min_d = c.overlap_f * sum_r;
  const bool hit_l = ok && (dist2 <= min_d * min_d);
  const float coh_d = c.cohesion_f * sum_r;
  const bool hit_c =
      cohesion && ok && (sb == ob) && (dist2 <= coh_d * coh_d);
  // neither constraint fires: both numerators are zero, and 0 / den is 0
  if (!hit_l && !hit_c) return 0.0f;
  const bool deg = dist2 <= kEps2;
  const float inv_d1 = deg ? 1.0f : rsqrtf(fmaxf(dist2, kEps2));
  const float nd = deg ? 0.0f : 1.0f;
  const float f_l = hit_l ? min_d * inv_d1 - nd : 0.0f;
  const float dl = fmaxf(w_sum + c.collision_c, 1.0f);
  if (!cohesion) return f_l / dl;
  const float f_c = hit_c ? coh_d * inv_d1 - nd : 0.0f;
  const float dc = fmaxf(w_sum + c.cohesion_c, 1.0f);
  return (f_c * dl + f_l * dc) / (dc * dl);
}

}  // namespace egg
