// Kernels D and E: the pair sweep of the dense engine on halo-padded planes.
//
// Replaces: egg_fluid_simulation_tpu/ops/pallas/sweep_kernel.py
//           D: _sweep_pallas (_make_kernel, body _pair_terms);
//           E: _sweep_pallas_sym (_make_kernel_sym, body _pair_terms_sym).
//
// Layout: planes (8, G + 2*ROW_PAD, L) float32, fields ops.dense.FIELD_*;
// real row r lives at plane row ROW_PAD + r and the ROW_PAD halo rows above
// and below hold copies of the opposite edge rows (the torus in y); L = G*K,
// lane = cell_x * K + slot, wrapped (the torus in x). params (8,) =
// SweepParams.pack(), read from device memory. Output (2, G, L): the x and y
// correction sums of every real slot (0 for empty slots).
//
// D: one thread per (row, lane) self slot. It sums, over partner rows
// r + dy (dy in [-w, w], read through the halo rows: w <= 3 <= ROW_PAD) and
// partner lanes (l - d) mod L, the collision + same-batch cohesion
// corrections of the trimmed XPBD projection, in the plain version's order
// (dy outer, d inner: dense.sweep_planes_jnp), so the sums round alike. The
// TPU kernel skipped row blocks with no occupied slot; here an empty self
// slot writes 0 and returns. Options: the ordered cutoff cum_min < max_pairs,
// the fresh-cell mask (window 3), the occupancy boost clip(occ / K, 1, cap).
// `wide_flag` (optional device int) selects window 3 + fresh mask when
// nonzero, window 1 when zero: the violence gate never syncs the host.
//
// E: the same sums, each unordered pair evaluated once. A thread takes the
// half-space of offsets dy > 0, or dy == 0 and d > 0 (d outer, dy inner, as
// _pair_terms_sym), keeps its own side in registers and adds the partner's
// opposite push to the partner slot (row + dy, lane - d), wrapped, with a
// global atomicAdd; its own sum goes in with one atomicAdd at the end. The
// output must start zeroed. The order of the atomic adds changes from run to
// run, so E agrees with its plain version to rounding, not bit for bit.
//
// Bound on the H100: pair arithmetic and L1/L2 traffic of the partner reads.
// A window-1 slot evaluates up to 3 * (4K - 1) partner terms (E about half);
// partners of neighbouring threads are neighbouring lanes, so a warp's loads
// coalesce and stay in L1. Terms ruled out by the lane mask, the partner's
// occupancy or the ordered cutoff are skipped before the other fields load
// (a skipped term adds exactly zero).

#include "pair_terms.cuh"

namespace {

using namespace egg;

// The launch's scalars and the self slot's fields, shared by D and E.
struct Sweep {
  long long F;  // elements per field: (G + 2*ROW_PAD) * L
  long long s;  // the self slot's offset within a field
  int r, l, w, fresh;
  PairConsts pc;
  float max_pairs, cell_size, boost_hi, inv_k, fm;
  float sx, sy, sw, sr, sb, scum, sidx, socc, sfx, sfy;
};

// The thread's slot, the window in force and the self occupancy; false past
// the grid.
__device__ __forceinline__ bool setup(const float* P, long long idx, int g,
                                      int lanes, int window, int fresh_mask,
                                      const int* wide_flag, Sweep* t) {
  if (idx >= static_cast<long long>(g) * lanes) return false;
  t->F = static_cast<long long>(g + 2 * kRowPad) * lanes;
  t->r = static_cast<int>(idx / lanes);
  t->l = static_cast<int>(idx - static_cast<long long>(t->r) * lanes);
  t->s = static_cast<long long>(t->r + kRowPad) * lanes + t->l;
  t->w = window;
  t->fresh = fresh_mask;
  if (wide_flag != nullptr) {
    const bool wide = *wide_flag != 0;
    t->w = wide ? 3 : 1;
    t->fresh = wide ? 1 : 0;
  }
  t->socc = P[kOcc * t->F + t->s];
  return true;
}

// The rest of the self slot's fields and the scalars of params.
__device__ __forceinline__ void load_self(const float* P, const float* params,
                                          int lanes, int k, Sweep* t) {
  t->pc = pair_consts(params);
  t->max_pairs = params[4];
  t->cell_size = params[5];
  t->fm = params[6] > 0.0f ? params[6] : static_cast<float>(lanes / k);
  t->boost_hi = fmaxf(params[7], 1.0f);
  t->inv_k = 1.0f / static_cast<float>(k);
  t->sfx = t->sfy = 0.0f;
  const long long F = t->F, s = t->s;
  t->sx = P[kX * F + s];
  t->sy = P[kY * F + s];
  t->sw = P[kW * F + s];
  t->sr = P[kR * F + s];
  t->sb = P[kBatch * F + s];
  t->scum = P[kCum * F + s];
  t->sidx = P[kIdx * F + s];
  if (t->fresh) {
    t->sfx = fresh_cell(t->sx, t->cell_size, t->fm);
    t->sfy = fresh_cell(t->sy, t->cell_size, t->fm);
  }
}

// The gates of partner slot o that need no pair math: occupancy, the
// ordered cutoff cum_min < max_pairs, the fresh-cell mask. A term they rule
// out adds exactly zero, so it is skipped before the other fields load.
__device__ __forceinline__ bool partner_ok(const float* P, long long o,
                                           const Sweep& t, int ordered,
                                           float* oocc, float* ox, float* oy) {
  const long long F = t.F;
  *oocc = P[kOcc * F + o];
  if (!(*oocc > 0.0f)) return false;
  if (ordered) {
    const float oidx = P[kIdx * F + o];
    const float cum_min = oidx < t.sidx ? P[kCum * F + o] : t.scum;
    if (!(cum_min < t.max_pairs)) return false;
  }
  *ox = P[kX * F + o];
  *oy = P[kY * F + o];
  return !t.fresh ||
         (torus_adjacent(t.sfx, fresh_cell(*ox, t.cell_size, t.fm), t.fm) &&
          torus_adjacent(t.sfy, fresh_cell(*oy, t.cell_size, t.fm), t.fm));
}

__global__ void sweep_planes_kernel(const float* __restrict__ P,
                                    const float* __restrict__ params,
                                    const int* __restrict__ wide_flag,
                                    float* __restrict__ out, int g, int lanes,
                                    int k, int window, int fresh_mask,
                                    int cohesion, int ordered) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  Sweep t;
  if (!setup(P, idx, g, lanes, window, fresh_mask, wide_flag, &t)) return;
  const long long gl = static_cast<long long>(g) * lanes;
  if (!(t.socc > 0.0f)) {  // empty self slot: every pair is invalid
    out[idx] = 0.0f;
    out[gl + idx] = 0.0f;
    return;
  }
  load_self(P, params, lanes, k, &t);
  const long long F = t.F;
  float tx = 0.0f, ty = 0.0f;
  const int d_hi = (t.w + 1) * k;
  const int s_lane = t.l % k;
  for (int dy = -t.w; dy <= t.w; ++dy) {
    const long long orow = static_cast<long long>(t.r + kRowPad + dy) * lanes;
    for (int d = -(d_hi - 1); d < d_hi; ++d) {
      if (dy == 0 && d == 0) continue;
      if (!lane_ok(s_lane, d, k, t.w)) continue;
      const long long o = orow + wrap(t.l - d, lanes);
      float oocc, ox, oy;
      if (!partner_ok(P, o, t, ordered, &oocc, &ox, &oy)) continue;
      const float ddx = ox - t.sx;
      const float ddy = oy - t.sy;
      const float dist2 = ddx * ddx + ddy * ddy;
      const bool deg = dist2 <= kEps2;
      const float ratio = pair_ratio(
          dist2, t.sw, P[kW * F + o], t.sr, P[kR * F + o], t.sb,
          cohesion ? P[kBatch * F + o] : 0.0f, cohesion != 0, t.pc);
      const float boost = fminf(fmaxf(oocc * t.inv_k, 1.0f), t.boost_hi);
      const float s_eff = ratio * (t.sw * boost);
      const float sgn = (dy > 0 || (dy == 0 && d > 0)) ? 1.0f : -1.0f;
      const float ux = deg ? sgn * kTieX : ddx;
      const float uy = deg ? sgn * kTieY : ddy;
      tx = tx - ux * s_eff;
      ty = ty - uy * s_eff;
    }
  }
  out[idx] = tx;
  out[gl + idx] = ty;
}

__global__ void sweep_planes_sym_kernel(const float* __restrict__ P,
                                        const float* __restrict__ params,
                                        const int* __restrict__ wide_flag,
                                        float* __restrict__ out, int g,
                                        int lanes, int k, int window,
                                        int fresh_mask, int cohesion,
                                        int ordered) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  Sweep t;
  if (!setup(P, idx, g, lanes, window, fresh_mask, wide_flag, &t)) return;
  if (!(t.socc > 0.0f)) return;  // no valid pair: the zeroed output stays 0
  load_self(P, params, lanes, k, &t);
  const long long F = t.F;
  const long long gl = static_cast<long long>(g) * lanes;
  const float boost_o = fminf(fmaxf(t.socc * t.inv_k, 1.0f), t.boost_hi);
  float tx = 0.0f, ty = 0.0f;
  const int d_hi = (t.w + 1) * k;
  const int s_lane = t.l % k;
  for (int d = -(d_hi - 1); d < d_hi; ++d) {
    if (!lane_ok(s_lane, d, k, t.w)) continue;
    const int ol = wrap(t.l - d, lanes);
    for (int dy = (d > 0 ? 0 : 1); dy <= t.w; ++dy) {
      const long long o =
          static_cast<long long>(t.r + kRowPad + dy) * lanes + ol;
      float oocc, ox, oy;
      if (!partner_ok(P, o, t, ordered, &oocc, &ox, &oy)) continue;
      const float ow = P[kW * F + o];
      const float ddx = ox - t.sx;
      const float ddy = oy - t.sy;
      const float dist2 = ddx * ddx + ddy * ddy;
      const bool deg = dist2 <= kEps2;
      const float ratio = pair_ratio(
          dist2, t.sw, ow, t.sr, P[kR * F + o], t.sb,
          cohesion ? P[kBatch * F + o] : 0.0f, cohesion != 0, t.pc);
      if (ratio == 0.0f) continue;  // both sides' terms are exactly zero
      const float boost_s = fminf(fmaxf(oocc * t.inv_k, 1.0f), t.boost_hi);
      // half-space terms carry sgn = +1; the partner gets the opposite push
      const float ux = deg ? kTieX : ddx;
      const float uy = deg ? kTieY : ddy;
      tx = tx - ux * (ratio * (t.sw * boost_s));
      ty = ty - uy * (ratio * (t.sw * boost_s));
      const long long p =
          static_cast<long long>(wrap(t.r + dy, g)) * lanes + ol;
      atomicAdd(out + p, ux * (ratio * (ow * boost_o)));
      atomicAdd(out + gl + p, uy * (ratio * (ow * boost_o)));
    }
  }
  atomicAdd(out + idx, tx);
  atomicAdd(out + gl + idx, ty);
}

}  // namespace

extern "C" int egg_sweep_planes(const float* planes, const float* params,
                                const int* wide_flag, float* out, int g,
                                int lanes, int k, int window, int fresh_mask,
                                int cohesion, int ordered,
                                cudaStream_t stream) {
  const long long n = static_cast<long long>(g) * lanes;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sweep_planes_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      planes, params, wide_flag, out, g, lanes, k, window, fresh_mask,
      cohesion, ordered);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int egg_sweep_planes_sym(const float* planes, const float* params,
                                    const int* wide_flag, float* out, int g,
                                    int lanes, int k, int window,
                                    int fresh_mask, int cohesion, int ordered,
                                    cudaStream_t stream) {
  const long long n = static_cast<long long>(g) * lanes;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sweep_planes_sym_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            stream>>>(planes, params, wide_flag, out, g, lanes,
                                      k, window, fresh_mask, cohesion,
                                      ordered);
  return static_cast<int>(cudaGetLastError());
}
