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
// D: every real slot sums, over partner rows r + dy (dy in [-w, w], read
// through the halo rows: w <= 3 <= ROW_PAD) and partner lanes (l - d) mod L,
// the collision + same-batch cohesion corrections of the trimmed XPBD
// projection, in the plain version's order (dy outer, d inner:
// dense.sweep_planes_jnp), so the sums round alike. Options: the ordered
// cutoff cum_min < max_pairs, the fresh-cell mask (window 3), the occupancy
// boost clip(occ / K, 1, cap). `wide_flag` (optional device int) selects
// window 3 + fresh mask when nonzero, window 1 when zero: the violence gate
// never syncs the host.
//
// D's design (sweep_tile.cuh): a block owns a tile of 8 rows x 128 lanes
// (whole cells; 256 threads, 512 where the launch may run window 3). It
// lists the tile's occupied slots from FIELD_OCC and writes the zeros of the
// empty ones (the TPU kernel skipped row blocks with no occupied slot; here
// a tile with none ends after reading 4 bytes a slot). Otherwise it stages
// the tile with its halo (w plane rows, w cells, the lane wrap resolved once
// per staged slot) into shared memory, the 8 plane fields a slot and, with
// the fresh mask, the slot's fresh cell formed once: at K = 4, 10 x 136
// slots = 45 KB with the list at window 1 (1.33x the tile), 14 x 152 slots =
// 85 KB at window 3 (opt-in above 48 KB). With `wide_flag` the launch is
// sized for window 3 and the block lays out the halo in force. Threads walk
// the list of occupied slots and read partners from shared memory at fixed
// offsets; the window is a template argument, so the row loop unrolls.
// Bound on the H100: instructions, not bytes. Nothing in the pair loop
// touches global memory; what is left is the walk over the 3 x 12 partner
// slots of each occupied slot and the pair arithmetic, one rsqrtf and one
// IEEE divide a firing pair under --fmad=false (a pair whose constraints do
// not fire adds exactly zero and leaves before both; the ordered cutoff
// rules pairs out before any arithmetic). ptxas -v: 62 registers, no spills,
// one barrier; capping the registers for more blocks an SM measured slower.
//
// E: the same sums, each unordered pair evaluated once. One thread per
// (row, lane) self slot, partners read from global memory through L1. A
// thread takes the half-space of offsets dy > 0, or dy == 0 and d > 0 (d
// outer, dy inner, as _pair_terms_sym), keeps its own side in registers and
// adds the partner's opposite push to the partner slot (row + dy, lane - d),
// wrapped, with a global atomicAdd; its own sum goes in with one atomicAdd
// at the end. The output must start zeroed. The order of the atomic adds
// changes from run to run, so E agrees with its plain version to rounding,
// not bit for bit. E is bound by the pair arithmetic and the L1/L2 traffic
// of its partner reads: a window-1 slot evaluates up to 3 * (4K - 1) / 2
// partner terms, and terms ruled out by the lane mask, the partner's
// occupancy or the ordered cutoff are skipped before the other fields load
// (a skipped term adds exactly zero).

#include "sweep_tile.cuh"

namespace {

using namespace egg;

// Kernel E: the launch's scalars and the self slot's fields.
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

// Kernel D, one tile at window WIN (a template argument, so the row loop
// unrolls).
template <int WIN>
__device__ __forceinline__ void sweep_planes_tile(
    const float* __restrict__ P, const float* __restrict__ params,
    float* __restrict__ out, int g, int lanes, int k, int fresh_mask,
    int cohesion, int ordered, unsigned char* smem, int* n_listed) {
  const Tile t = make_tile(WIN, fresh_mask, k);
  const int plane_rows = g + 2 * kRowPad;
  const long long F = static_cast<long long>(plane_rows) * lanes;
  const long long gl = static_cast<long long>(g) * lanes;

  auto write_empty = [&](long long idx) {  // no valid pair: the sums are 0
    out[idx] = 0.0f;
    out[gl + idx] = 0.0f;
  };
  unsigned short* list = reinterpret_cast<unsigned short*>(smem);
  const int n_list = tile_compact(
      t, g, lanes, list, n_listed,
      [&](int r, int l) {
        return P[kOcc * F + static_cast<long long>(r + kRowPad) * lanes + l];
      },
      [&](int r, int l) {
        write_empty(static_cast<long long>(r) * lanes + l);
      });
  if (n_list == 0) return;

  const PairConsts pc = pair_consts(params);
  const float max_pairs = params[4];
  const float cell_size = params[5];
  const float fm = params[6] > 0.0f ? params[6] : static_cast<float>(lanes / k);
  const float boost_hi = fmaxf(params[7], 1.0f);
  const float inv_k = 1.0f / static_cast<float>(k);
  const bool whole = whole_modulus(fm);

  // ---- stage the tile and its halo: lane wrap and fresh cell once a slot;
  // staged field f of staged slot i lives at S[f * n_stage + i]
  float* S = reinterpret_cast<float*>(smem + tile_list_bytes(t.tl, t.tr));
  float* sFX = S + 8 * t.n_stage;  // with the fresh mask only
  float* sFY = sFX + t.n_stage;
  for (int i = threadIdx.x; i < t.n_stage; i += blockDim.x) {
    const int srow = i / t.sw;
    const int prow = t.r0 - t.w + srow + kRowPad;  // plane row, halo included
    const int pl = wrap_any(t.l0 - t.hl + (i - srow * t.sw), lanes);
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (prow < plane_rows) {  // rows past the planes serve no real slot
      const long long o = static_cast<long long>(prow) * lanes + pl;
      v[kOcc] = P[kOcc * F + o];
      if (v[kOcc] > 0.0f) {  // the fields of an empty slot are never read
#pragma unroll
        for (int f = 0; f < kOcc; ++f) v[f] = P[f * F + o];
      }
    }
#pragma unroll
    for (int f = 0; f < 8; ++f) S[f * t.n_stage + i] = v[f];
    if (t.fresh) {
      sFX[i] = fresh_cell(v[kX], cell_size, fm);
      sFY[i] = fresh_cell(v[kY], cell_size, fm);
    }
  }
  __syncthreads();

  // ---- the pair sums of the listed slots, partners from shared memory
  const float* sX = S + kX * t.n_stage;
  const float* sY = S + kY * t.n_stage;
  const float* sW = S + kW * t.n_stage;
  const float* sR = S + kR * t.n_stage;
  const float* sB = S + kBatch * t.n_stage;
  const float* sCum = S + kCum * t.n_stage;
  const float* sIdx = S + kIdx * t.n_stage;
  const float* sO = S + kOcc * t.n_stage;
  const int n_partner_lanes = (2 * WIN + 1) * k;
  for (int j = threadIdx.x; j < n_list; j += blockDim.x) {
    const int i = list[j];
    const int trow = i / t.tl;
    const int tlane = i - trow * t.tl;
    const long long idx =
        static_cast<long long>(t.r0 + trow) * lanes + t.l0 + tlane;
    const int sl = tlane + t.hl;              // staged lane of the self slot
    const int c = (trow + WIN) * t.sw + sl;
    if (!kCompact && !(sO[c] > 0.0f)) {
      write_empty(idx);
      continue;
    }
    const float sx = sX[c], sy = sY[c], sw = sW[c], sr = sR[c], sb = sB[c];
    const float scum = sCum[c], sidx = sIdx[c];
    float sfx = 0.0f, sfy = 0.0f;
    if (t.fresh) {
      sfx = sFX[c];
      sfy = sFY[c];
    }
    // partner lanes: the cells cx - w .. cx + w, walked from the highest lane
    // down, which is d = (l - partner lane) ascending
    const int pl_lo = (tlane / k) * k;        // staged lane, cell cx - w slot 0
    float tx = 0.0f, ty = 0.0f;
#pragma unroll
    for (int dy = -WIN; dy <= WIN; ++dy) {
      const int row = (trow + WIN + dy) * t.sw;
      for (int pl = pl_lo + n_partner_lanes - 1; pl >= pl_lo; --pl) {
        const int d = sl - pl;
        if (dy == 0 && d == 0) continue;
        const int o = row + pl;
        const float oocc = sO[o];
        if (!(oocc > 0.0f)) continue;
        if (ordered) {
          const float cum_min = sIdx[o] < sidx ? sCum[o] : scum;
          if (!(cum_min < max_pairs)) continue;
        }
        if (t.fresh &&
            !(cells_adjacent(sfx, sFX[o], fm, whole) &&
              cells_adjacent(sfy, sFY[o], fm, whole)))
          continue;
        const float ddx = sX[o] - sx;
        const float ddy = sY[o] - sy;
        const float dist2 = ddx * ddx + ddy * ddy;
        const float ratio =
            pair_ratio(dist2, sw, sW[o], sr, sR[o], sb,
                       cohesion ? sB[o] : 0.0f, cohesion != 0, pc);
        if (ratio == 0.0f) continue;          // the term is exactly zero
        const bool deg = dist2 <= kEps2;
        const float boost = fminf(fmaxf(oocc * inv_k, 1.0f), boost_hi);
        const float s_eff = ratio * (sw * boost);
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
}

__global__ void __launch_bounds__(kTileThreadsWide, 2) sweep_planes_kernel(
    const float* __restrict__ P, const float* __restrict__ params,
    const int* __restrict__ wide_flag, float* __restrict__ out, int g,
    int lanes, int k, int window, int fresh_mask, int cohesion, int ordered) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_listed;
  window_in_force(wide_flag, &window, &fresh_mask);
  if (window == 1)
    sweep_planes_tile<1>(P, params, out, g, lanes, k, fresh_mask, cohesion,
                         ordered, smem, &n_listed);
  else
    sweep_planes_tile<3>(P, params, out, g, lanes, k, fresh_mask, cohesion,
                         ordered, smem, &n_listed);
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
  const egg::TileLaunch at = egg::tile_launch(
      g, lanes, k, window, fresh_mask, wide_flag != nullptr, 8);
  const cudaError_t err = egg::tile_allow_smem(sweep_planes_kernel, at.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_planes_kernel<<<at.grid, at.threads, at.smem, stream>>>(
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
