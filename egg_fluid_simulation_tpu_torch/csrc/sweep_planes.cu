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
// correction sums of every real slot (0 for empty slots). D also takes a
// window of a torus, as the 2D spatial layer bins one rank's cells
// (parallel/spatial.py): G real rows whose halo rows hold the neighbouring
// bands' rows, L any multiple of K (the block's lanes and their halo lanes);
// nothing here assumes L = G*K, and the fresh-cell modulus comes from
// params[6] (the global grid there; 0 means L / K).
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
// E: the same sums, each unordered pair evaluated once, on the same tiles.
// A block lists its tile's occupied slots as D does and stages the tile with
// the half-space halo only: rows r0 .. r0 + 7 + w (a slot's partners lie at
// dy >= 0, so no rows above), w cells on each side, the 8 plane fields (and
// the fresh cells at window 3) a staged slot, the wrap resolved at staging.
// Beside the fields every staged slot has two float accumulators in shared
// memory (two arrays, so that neighbouring slots fall into neighbouring
// banks), zeroed at staging: at K = 4, 9 x 136 slots x 10 floats = 51 KB
// with the list at window 1, 11 x 152 x 12 = 82 KB at window 3 (opt-in above
// 48 KB); with `wide_flag` the launch is sized for window 3 and the block
// lays out fields and accumulators for the window in force. A thread takes a
// listed slot and walks its half-space partners: first its own row, the
// lanes below it (d > 0) down to the first lane of cell cx - w, then the
// rows below (dy = 1 .. w, unrolled) over the cells cx - w .. cx + w. The
// gates come in D's order (occupancy, ordered cutoff, fresh adjacency, then
// the pair ratio, leaving where it is 0). The thread keeps its own side in
// registers and adds the partner's opposite push to the partner's
// accumulators with shared-memory atomicAdds; its own sums go into its own
// accumulators the same way at the end. The slots of one cell sit next to
// each other in the list and would reach the same partner of a row below in
// the same iteration; at window 1 each starts that walk 3 lanes further on,
// so the atomics of a warp mostly hit different addresses. After a barrier
// every staged slot whose accumulators are not both zero is flushed with one
// global atomicAdd a component onto its real slot (row and lane wrapped; a
// grid smaller than a tile is staged several times over, and all copies of
// a real slot land on it). Interior slots also receive pushes from the tile
// above and from the lateral neighbours, so every flush is atomic and the
// output must start zeroed: the wrapper allocates it with torch.zeros (one
// memset a sweep, part of E's time wherever it is stated). The empty-slot
// path cannot zero it, since a neighbouring tile may have pushed already.
// The order of the atomic adds changes from run to run, so E agrees with
// its plain version to rounding, not bit for bit.
// Bound on the H100: instructions, and among them the shared-memory
// atomics. E walks half of D's partners, and its pair arithmetic takes half
// of D's time; but a float atomicAdd on shared memory is a compare-and-swap
// loop on this card (ATOMS.CAST.SPIN), and the two a firing pair cost about
// what the saved half of the arithmetic does. Listing, staging, the memset
// and the flush take a third of a window-1 launch. So at window 1 E takes
// D's time, at window 3 (the half-space of 7 x 28 partner slots a slot,
// where the walk dominates) about 70% of it. ptxas -v: 60 registers, no
// spills.

#include "sweep_tile.cuh"

namespace {

using namespace egg;

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

// Ablation builds of kernel E, used by profile_torch_sweeps.py only:
// -DEGG_SYM_NO_PUSH drops the partner-side adds (the pair arithmetic alone;
// the sums are then wrong), -DEGG_SYM_NO_WALK drops the pair loop (listing,
// staging and flush alone).
#ifdef EGG_SYM_NO_PUSH
constexpr bool kSymPush = false;
#else
constexpr bool kSymPush = true;
#endif
#ifdef EGG_SYM_NO_WALK
constexpr bool kSymWalk = false;
#else
constexpr bool kSymWalk = true;
#endif

// Kernel E, one tile at window WIN.
template <int WIN>
__device__ __forceinline__ void sweep_planes_sym_tile(
    const float* __restrict__ P, const float* __restrict__ params,
    float* __restrict__ out, int g, int lanes, int k, int fresh_mask,
    int cohesion, int ordered, unsigned char* smem, int* n_listed) {
  const Tile t = make_tile(WIN, fresh_mask, k, /*half_space=*/true);
  const int plane_rows = g + 2 * kRowPad;
  const long long F = static_cast<long long>(plane_rows) * lanes;
  const long long gl = static_cast<long long>(g) * lanes;

  unsigned short* list = reinterpret_cast<unsigned short*>(smem);
  const int n_list = tile_compact(
      t, g, lanes, list, n_listed,
      [&](int r, int l) {
        return P[kOcc * F + static_cast<long long>(r + kRowPad) * lanes + l];
      },
      [](int, int) {});  // an empty slot's sums are the zeros out starts with
  if (n_list == 0) return;

  const PairConsts pc = pair_consts(params);
  const float max_pairs = params[4];
  const float cell_size = params[5];
  const float fm = params[6] > 0.0f ? params[6] : static_cast<float>(lanes / k);
  const float boost_hi = fmaxf(params[7], 1.0f);
  const float inv_k = 1.0f / static_cast<float>(k);
  const bool whole = whole_modulus(fm);

  // ---- stage rows r0 .. r0 + tr - 1 + w with the lane halo; staged field f
  // of staged slot i lives at S[f * n_stage + i]; then the fresh cells (with
  // the mask) and the two accumulators of the layout in force
  float* S = reinterpret_cast<float*>(smem + tile_list_bytes(t.tl, t.tr));
  float* sFX = S + 8 * t.n_stage;  // with the fresh mask only
  float* sFY = sFX + t.n_stage;
  float* aX = S + (t.fresh ? 10 : 8) * t.n_stage;
  float* aY = aX + t.n_stage;
  for (int i = threadIdx.x; i < t.n_stage; i += blockDim.x) {
    const int srow = i / t.sw;
    const int prow = t.r0 + srow + kRowPad;  // plane row, halo included
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
    aX[i] = 0.0f;
    aY[i] = 0.0f;
  }
  __syncthreads();

  // ---- each listed slot's half-space pairs: its own side in registers, the
  // partner's opposite push into the partner's accumulator
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
    const int sl = tlane + t.hl;              // staged lane of the self slot
    const int c = trow * t.sw + sl;
    const float socc = sO[c];
    if (!kCompact && !(socc > 0.0f)) continue;
    const float sx = sX[c], sy = sY[c], sw = sW[c], sr = sR[c], sb = sB[c];
    const float scum = sCum[c], sidx = sIdx[c];
    float sfx = 0.0f, sfy = 0.0f;
    if (t.fresh) {
      sfx = sFX[c];
      sfy = sFY[c];
    }
    const float boost_o = fminf(fmaxf(socc * inv_k, 1.0f), boost_hi);
    float tx = 0.0f, ty = 0.0f;
    // one half-space partner, at staged slot o (the gates in D's order; a
    // term they rule out is exactly zero on both sides)
    auto pair = [&](int o) {
      const float oocc = sO[o];
      if (!(oocc > 0.0f)) return;
      if (ordered) {
        const float cum_min = sIdx[o] < sidx ? sCum[o] : scum;
        if (!(cum_min < max_pairs)) return;
      }
      if (t.fresh &&
          !(cells_adjacent(sfx, sFX[o], fm, whole) &&
            cells_adjacent(sfy, sFY[o], fm, whole)))
        return;
      const float ow = sW[o];
      const float ddx = sX[o] - sx;
      const float ddy = sY[o] - sy;
      const float dist2 = ddx * ddx + ddy * ddy;
      const float ratio =
          pair_ratio(dist2, sw, ow, sr, sR[o], sb, cohesion ? sB[o] : 0.0f,
                     cohesion != 0, pc);
      if (ratio == 0.0f) return;              // both sides' terms are zero
      const bool deg = dist2 <= kEps2;
      const float boost_s = fminf(fmaxf(oocc * inv_k, 1.0f), boost_hi);
      // half-space terms carry sgn = +1; the partner gets the opposite push
      const float ux = deg ? kTieX : ddx;
      const float uy = deg ? kTieY : ddy;
      const float s_eff = ratio * (sw * boost_s);
      tx = tx - ux * s_eff;
      ty = ty - uy * s_eff;
      if (kSymPush) {
        const float o_eff = ratio * (ow * boost_o);
        atomicAdd(aX + o, ux * o_eff);
        atomicAdd(aY + o, uy * o_eff);
      }
    };
    const int cell_slot = tlane % k;
    const int pl_lo = tlane - cell_slot;  // staged lane, cell cx - w slot 0
    if (kSymWalk) {
      // the slot's own row: the lanes below it (d > 0), nearest first. The
      // slots of a cell reach different partners in the same iteration.
      for (int pl = sl - 1; pl >= pl_lo; --pl) pair(trow * t.sw + pl);
      // the rows below: the cells cx - w .. cx + w from the highest lane
      // down. At window 1 the start is rotated by the slot's place in its
      // cell, so that the slots of a cell, neighbours in the list, push to
      // different partners (measured: 4% faster at window 1, 7% slower at
      // window 3, where it stays off)
      int at = WIN == 1 ? cell_slot * (2 * WIN + 1) : 0;
      for (int it = 0; it < n_partner_lanes; ++it) {
        const int pl = pl_lo + n_partner_lanes - 1 - at;
        at = at + 1 == n_partner_lanes ? 0 : at + 1;
#pragma unroll
        for (int dy = 1; dy <= WIN; ++dy) pair((trow + dy) * t.sw + pl);
      }
    }
    atomicAdd(aX + c, tx);
    atomicAdd(aY + c, ty);
  }
  __syncthreads();

  // ---- flush: one global atomicAdd a component and staged slot that
  // received anything, onto its real slot
  for (int i = threadIdx.x; i < t.n_stage; i += blockDim.x) {
    const float ax = aX[i], ay = aY[i];
    if (ax == 0.0f && ay == 0.0f) continue;
    const int srow = i / t.sw;
    const int r = wrap_any(t.r0 + srow, g);
    const int l = wrap_any(t.l0 - t.hl + (i - srow * t.sw), lanes);
    const long long p = static_cast<long long>(r) * lanes + l;
    atomicAdd(out + p, ax);
    atomicAdd(out + gl + p, ay);
  }
}

__global__ void __launch_bounds__(kTileThreadsWide, 2) sweep_planes_sym_kernel(
    const float* __restrict__ P, const float* __restrict__ params,
    const int* __restrict__ wide_flag, float* __restrict__ out, int g,
    int lanes, int k, int window, int fresh_mask, int cohesion, int ordered) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_listed;
  window_in_force(wide_flag, &window, &fresh_mask);
  if (window == 1)
    sweep_planes_sym_tile<1>(P, params, out, g, lanes, k, fresh_mask, cohesion,
                             ordered, smem, &n_listed);
  else
    sweep_planes_sym_tile<3>(P, params, out, g, lanes, k, fresh_mask, cohesion,
                             ordered, smem, &n_listed);
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
  // 8 plane fields and the two accumulators a staged slot; `out` zeroed
  const egg::TileLaunch at = egg::tile_launch(
      g, lanes, k, window, fresh_mask, wide_flag != nullptr, 10,
      /*half_space=*/true);
  const cudaError_t err =
      egg::tile_allow_smem(sweep_planes_sym_kernel, at.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  sweep_planes_sym_kernel<<<at.grid, at.threads, at.smem, stream>>>(
      planes, params, wide_flag, out, g, lanes, k, window, fresh_mask,
      cohesion, ordered);
  return static_cast<int>(cudaGetLastError());
}
