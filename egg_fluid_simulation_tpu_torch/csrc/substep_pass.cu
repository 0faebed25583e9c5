// Kernel B: one fused collision pass of the dense engine, component layout.
//
// Replaces: egg_fluid_simulation_tpu/ops/pallas/sweep_kernel.py
//           (_substep_pass_pallas / _make_pass_kernel, pair math of
//           _pair_terms(occ_is_boost=True), prologue _follow_prologue).
//
// Layout: xy (2, G, L), stat (4, G, L) = [W, R, BATCH, boost], prev (2, G, L),
// follow (3, G, L) = [TX, TY, TD]; L = G * K, lane = cell_x * K + slot. The
// grid is a torus in rows and lanes. params (8,) = SweepParams.pack(),
// aux (4,) = [damp, follow_c, relax, 0]; both are read from device memory,
// so a step needs no host round trip.
//
// One thread per (row, lane) slot. With `integrate` the thread first applies
// damped integration x += damp * (x - prev) and the XPBD follow correction
// to its own slot, and recomputes the same (elementwise) prologue for every
// partner it reads, as the TPU kernel does per block: one launch per pass
// stays correct without a separate prologue pass. Then it sums the pair
// corrections over partner lanes (l - d) mod L and rows (r + dy) mod G in
// exactly the order of _pair_terms (d outer, dy inner), so the sums round
// alike. Partners read the pre-pass positions (Jacobi): the output is a new
// tensor. Empty slots (boost == 0) write 0, which is what the TPU kernel
// yields for them (all their fields are zero).
//
// `wide_flag` (optional device int): nonzero selects window 3 with the
// fresh-cell mask, zero window 1. The violence gate lives on the device and
// the host never waits on it.
//
// Bound on the H100: pair arithmetic and L1/L2 traffic. A window-1 pass
// evaluates up to 3 * (4K - 1) partner terms per slot, and with `integrate`
// re-derives each partner's integrated position (one sqrt and one divide
// each). Partners of neighbouring threads are neighbouring lanes, so the
// loads of a warp coalesce and stay in L1; terms whose lane mask or partner
// occupancy rules them out are skipped before any load of the other fields
// (a skipped term would add exactly zero).
//
// Numerics: no --use_fast_math, and the library is built with --fmad=false.
// rsqrtf, sqrtf and '/' stay as written, and no multiply-add is contracted,
// so every operation rounds as the plain PyTorch version's separate
// elementwise ops do. The pair math is pair_terms.cuh's, shared with the
// plane sweeps (sweep_planes.cu).

#include "pair_terms.cuh"

namespace {

using namespace egg;

// damped integration + XPBD follow (solver._follow_delta)
__device__ __forceinline__ void prologue(const float* __restrict__ xy,
                                         const float* __restrict__ stat,
                                         const float* __restrict__ prev,
                                         const float* __restrict__ follow,
                                         long long plane, long long o,
                                         float damp, float follow_c,
                                         float* xf, float* yf) {
  const float X = xy[o];
  const float Y = xy[plane + o];
  const float xi = X + damp * (X - prev[o]);
  const float yi = Y + damp * (Y - prev[plane + o]);
  const float W = stat[o];
  const float OC = stat[3 * plane + o];
  const float TD = follow[2 * plane + o];
  const float dx = follow[o] - xi;
  const float dy = follow[plane + o] - yi;
  const float dist = sqrtf(dx * dx + dy * dy);
  const float inv_dist = dist > kEps ? 1.0f / fmaxf(dist, kEps) : 0.0f;
  const float violation = dist - TD;
  const float delta_lambda = violation / (W + follow_c);
  const bool apply = (OC > 0.0f) && (W > kEps) && (dist > TD);
  const float scale = apply ? delta_lambda * W * inv_dist : 0.0f;
  *xf = xi + dx * scale;
  *yf = yi + dy * scale;
}

__global__ void substep_pass_kernel(
    const float* __restrict__ xy, const float* __restrict__ stat,
    const float* __restrict__ prev, const float* __restrict__ follow,
    const float* __restrict__ params, const float* __restrict__ aux,
    const int* __restrict__ wide_flag, float* __restrict__ out_xy,
    float* __restrict__ out_prev, int g, int lanes, int k, int window,
    int fresh_mask, int cohesion, int integrate) {
  const long long plane = static_cast<long long>(g) * lanes;
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= plane) return;
  if (wide_flag != nullptr) {
    const bool wide = *wide_flag != 0;
    window = wide ? 3 : 1;
    fresh_mask = wide ? 1 : 0;
  }
  const float s_boost = stat[3 * plane + idx];
  if (!(s_boost > 0.0f)) {  // empty slot: every field is zero
    out_xy[idx] = 0.0f;
    out_xy[plane + idx] = 0.0f;
    if (integrate) {
      out_prev[idx] = 0.0f;
      out_prev[plane + idx] = 0.0f;
    }
    return;
  }
  const int r = static_cast<int>(idx / lanes);
  const int l = static_cast<int>(idx - static_cast<long long>(r) * lanes);

  const float damp = aux[0];
  const float follow_c = aux[1];
  const float relax = aux[2];
  const PairConsts pc = pair_consts(params);
  const float cell_size = params[5];
  const float fresh_mod = params[6];

  float sx, sy;
  if (integrate) {
    prologue(xy, stat, prev, follow, plane, idx, damp, follow_c, &sx, &sy);
  } else {
    sx = xy[idx];
    sy = xy[plane + idx];
  }
  const float sw = stat[idx];
  const float sr = stat[plane + idx];
  const float sb = stat[2 * plane + idx];
  const float fm = fresh_mod > 0.0f ? fresh_mod : static_cast<float>(g);
  float sfx = 0.0f, sfy = 0.0f;
  if (fresh_mask) {
    sfx = fresh_cell(sx, cell_size, fm);
    sfy = fresh_cell(sy, cell_size, fm);
  }

  float tx = 0.0f, ty = 0.0f;
  const int w = window;
  const int d_hi = (w + 1) * k;
  const int s_lane = l % k;
  for (int d = -(d_hi - 1); d < d_hi; ++d) {
    if (!lane_ok(s_lane, d, k, w)) continue;
    const int ol = wrap(l - d, lanes);
    for (int dy = -w; dy <= w; ++dy) {
      if (dy == 0 && d == 0) continue;
      const int orow = wrap(r + dy, g);
      const long long o = static_cast<long long>(orow) * lanes + ol;
      const float oocc = stat[3 * plane + o];
      if (!(oocc > 0.0f)) continue;
      float ox, oy;
      if (integrate) {
        prologue(xy, stat, prev, follow, plane, o, damp, follow_c, &ox, &oy);
      } else {
        ox = xy[o];
        oy = xy[plane + o];
      }
      if (fresh_mask) {
        const float ofx = fresh_cell(ox, cell_size, fm);
        const float ofy = fresh_cell(oy, cell_size, fm);
        if (!(torus_adjacent(sfx, ofx, fm) && torus_adjacent(sfy, ofy, fm)))
          continue;
      }
      const float ow = stat[o];
      const float orr = stat[plane + o];
      const float ob = cohesion ? stat[2 * plane + o] : 0.0f;
      const float ddx = ox - sx;
      const float ddy = oy - sy;
      const float dist2 = ddx * ddx + ddy * ddy;
      const bool deg = dist2 <= kEps2;
      const float ratio = pair_ratio(dist2, sw, ow, sr, orr, sb, ob,
                                     cohesion != 0, pc);
      const float s_eff = ratio * (sw * oocc);
      const float sgn = (dy > 0 || (dy == 0 && d > 0)) ? 1.0f : -1.0f;
      const float ux = deg ? sgn * kTieX : ddx;
      const float uy = deg ? sgn * kTieY : ddy;
      tx = tx - ux * s_eff;
      ty = ty - uy * s_eff;
    }
  }
  out_xy[idx] = sx + relax * tx;
  out_xy[plane + idx] = sy + relax * ty;
  if (integrate) {
    out_prev[idx] = xy[idx];  // the position before integration
    out_prev[plane + idx] = xy[plane + idx];
  }
}

}  // namespace

extern "C" int egg_substep_pass(const float* xy, const float* stat,
                                const float* prev, const float* follow,
                                const float* params, const float* aux,
                                const int* wide_flag, float* out_xy,
                                float* out_prev, int g, int lanes, int k,
                                int window, int fresh_mask, int cohesion,
                                int integrate, cudaStream_t stream) {
  const long long plane = static_cast<long long>(g) * lanes;
  const int threads = 256;
  const long long blocks = (plane + threads - 1) / threads;
  substep_pass_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      xy, stat, prev, follow, params, aux, wide_flag, out_xy, out_prev, g,
      lanes, k, window, fresh_mask, cohesion, integrate);
  return static_cast<int>(cudaGetLastError());
}
