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
// With `integrate` a slot first takes damped integration
// x += damp * (x - prev) and the XPBD follow correction; then every slot sums
// the pair corrections over partner lanes (l - d) mod L and rows
// (r + dy) mod G in exactly the order of _pair_terms (d outer, dy inner), so
// the sums round alike. Partners read the pre-pass positions (Jacobi): the
// output is a new tensor. Empty slots (boost == 0) write 0, which is what the
// TPU kernel yields for them (all their fields are zero).
//
// `wide_flag` (optional device int): nonzero selects window 3 with the
// fresh-cell mask, zero window 1. The violence gate lives on the device and
// the host never waits on it.
//
// Design (sweep_tile.cuh): a block owns a tile of 8 rows x 128 lanes (whole
// cells; 256 threads, 512 where the launch may run window 3). It first lists
// the tile's occupied slots from the occupancy plane and writes the zeros of
// the empty ones; a tile with no occupied slot ends there, having read 4
// bytes a slot. Otherwise it stages the tile and its halo (w rows, w cells)
// into shared memory: per staged slot the torus wrap is resolved once, the
// prologue runs once (it is elementwise, so the staged position has the bits
// every reader would have derived), and with the fresh mask the slot's fresh
// cell is formed once. Six floats a slot are staged (x, y, W, R, BATCH,
// boost; eight with the fresh cells): at K = 4, 10 x 136 slots = 34 KB with
// the list at window 1 (1.33x the tile), 14 x 152 slots = 69 KB at window 3
// (2.08x), which needs the opt-in above 48 KB. With `wide_flag` the launch
// is sized for window 3 and the block lays out the halo in force. Threads
// then walk the list of occupied slots, so a warp's lanes all carry a
// particle, and read partners from shared memory at fixed offsets: no wrap,
// no lane mask, no global load in the pair loop; the window is a template
// argument, so the row loop unrolls.
//
// Bound on the H100: instructions, not bytes. Global traffic is the staged
// tile, 1.33x the tensors' bytes in occupied tiles, and nothing in the pair
// loop touches global memory; what is left is the walk over the 3 x 12
// partner slots of each occupied slot and the pair arithmetic, one rsqrtf
// and one IEEE divide a firing pair under --fmad=false (in a packed scene
// nearly every occupied partner fires). A pair whose constraints do not fire
// adds exactly zero and leaves before both. ptxas -v: 40 registers, 8 bytes
// spilled, one barrier; the registers are capped for three 512-thread blocks
// an SM, which measured faster than the 59 the compiler takes uncapped.
//
// Numerics: no --use_fast_math, and the library is built with --fmad=false.
// rsqrtf, sqrtf and '/' stay as written, and no multiply-add is contracted,
// so every operation rounds as the plain PyTorch version's separate
// elementwise ops do. The pair math is pair_terms.cuh's, shared with the
// plane sweeps (sweep_planes.cu).

#include "sweep_tile.cuh"

namespace {

using namespace egg;

// damped integration + XPBD follow (solver._follow_delta) of slot o
__device__ __forceinline__ void prologue(const float* __restrict__ xy,
                                         const float* __restrict__ prev,
                                         const float* __restrict__ follow,
                                         long long plane, long long o, float W,
                                         float OC, float damp, float follow_c,
                                         float* xf, float* yf) {
  const float X = xy[o];
  const float Y = xy[plane + o];
  const float xi = X + damp * (X - prev[o]);
  const float yi = Y + damp * (Y - prev[plane + o]);
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

// One tile at window WIN (a template argument, so the row loop unrolls).
template <int WIN>
__device__ __forceinline__ void substep_pass_tile(
    const float* __restrict__ xy, const float* __restrict__ stat,
    const float* __restrict__ prev, const float* __restrict__ follow,
    const float* __restrict__ params, const float* __restrict__ aux,
    float* __restrict__ out_xy, float* __restrict__ out_prev, int g, int lanes,
    int k, int fresh_mask, int cohesion, int integrate, unsigned char* smem,
    int* n_listed) {
  const Tile t = make_tile(WIN, fresh_mask, k);
  const long long plane = static_cast<long long>(g) * lanes;
  const float* __restrict__ occ_plane = stat + 3 * plane;

  auto write_empty = [&](long long idx) {  // empty slot: every field is zero
    out_xy[idx] = 0.0f;
    out_xy[plane + idx] = 0.0f;
    if (integrate) {
      out_prev[idx] = 0.0f;
      out_prev[plane + idx] = 0.0f;
    }
  };
  unsigned short* list = reinterpret_cast<unsigned short*>(smem);
  const int n_list = tile_compact(
      t, g, lanes, list, n_listed,
      [&](int r, int l) {
        return occ_plane[static_cast<long long>(r) * lanes + l];
      },
      [&](int r, int l) {
        write_empty(static_cast<long long>(r) * lanes + l);
      });
  if (n_list == 0) return;

  const float damp = aux[0];
  const float follow_c = aux[1];
  const float relax = aux[2];
  const PairConsts pc = pair_consts(params);
  const float cell_size = params[5];
  const float fm = params[6] > 0.0f ? params[6] : static_cast<float>(g);
  const bool whole = whole_modulus(fm);

  // ---- stage the tile and its halo: wrap, prologue, fresh cell once a slot
  float* sX = reinterpret_cast<float*>(smem + tile_list_bytes(t.tl, t.tr));
  float* sY = sX + t.n_stage;
  float* sW = sY + t.n_stage;
  float* sR = sW + t.n_stage;
  float* sB = sR + t.n_stage;
  float* sO = sB + t.n_stage;
  float* sFX = sO + t.n_stage;  // with the fresh mask only
  float* sFY = sFX + t.n_stage;
  for (int i = threadIdx.x; i < t.n_stage; i += blockDim.x) {
    const int srow = i / t.sw;
    const int gr = wrap_any(t.r0 - t.w + srow, g);
    const int gl = wrap_any(t.l0 - t.hl + (i - srow * t.sw), lanes);
    const long long o = static_cast<long long>(gr) * lanes + gl;
    const float occ = occ_plane[o];
    float x = 0.0f, y = 0.0f, W = 0.0f, R = 0.0f, B = 0.0f;
    if (occ > 0.0f) {  // the fields of an empty slot are never read
      W = stat[o];
      R = stat[plane + o];
      B = stat[2 * plane + o];
      if (integrate) {
        prologue(xy, prev, follow, plane, o, W, occ, damp, follow_c, &x, &y);
      } else {
        x = xy[o];
        y = xy[plane + o];
      }
    }
    sX[i] = x;
    sY[i] = y;
    sW[i] = W;
    sR[i] = R;
    sB[i] = B;
    sO[i] = occ;
    if (t.fresh) {
      sFX[i] = fresh_cell(x, cell_size, fm);
      sFY[i] = fresh_cell(y, cell_size, fm);
    }
  }
  __syncthreads();

  // ---- the pair sums of the listed slots, partners from shared memory
  const int n_partner_lanes = (2 * WIN + 1) * k;
  for (int j = threadIdx.x; j < n_list; j += blockDim.x) {
    const int i = list[j];
    const int trow = i / t.tl;
    const int tlane = i - trow * t.tl;
    const long long idx =
        static_cast<long long>(t.r0 + trow) * lanes + t.l0 + tlane;
    const int sl = tlane + t.hl;              // staged lane of the self slot
    const int c = (trow + WIN) * t.sw + sl;
    const float s_boost = sO[c];
    if (!kCompact && !(s_boost > 0.0f)) {
      write_empty(idx);
      continue;
    }
    const float sx = sX[c], sy = sY[c], sw = sW[c], sr = sR[c], sb = sB[c];
    float sfx = 0.0f, sfy = 0.0f;
    if (t.fresh) {
      sfx = sFX[c];
      sfy = sFY[c];
    }
    // partner lanes: the cells cx - w .. cx + w, walked from the highest lane
    // down, which is d = (l - partner lane) ascending
    const int pl_lo = (tlane / k) * k;        // staged lane, cell cx - w slot 0
    float tx = 0.0f, ty = 0.0f;
    for (int pl = pl_lo + n_partner_lanes - 1; pl >= pl_lo; --pl) {
      const int d = sl - pl;
#pragma unroll
      for (int dy = -WIN; dy <= WIN; ++dy) {
        if (dy == 0 && d == 0) continue;
        const int o = (trow + WIN + dy) * t.sw + pl;
        const float oocc = sO[o];
        if (!(oocc > 0.0f)) continue;
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
}

__global__ void __launch_bounds__(kTileThreadsWide, 3) substep_pass_kernel(
    const float* __restrict__ xy, const float* __restrict__ stat,
    const float* __restrict__ prev, const float* __restrict__ follow,
    const float* __restrict__ params, const float* __restrict__ aux,
    const int* __restrict__ wide_flag, float* __restrict__ out_xy,
    float* __restrict__ out_prev, int g, int lanes, int k, int window,
    int fresh_mask, int cohesion, int integrate) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_listed;
  window_in_force(wide_flag, &window, &fresh_mask);
  if (window == 1)
    substep_pass_tile<1>(xy, stat, prev, follow, params, aux, out_xy, out_prev,
                         g, lanes, k, fresh_mask, cohesion, integrate, smem,
                         &n_listed);
  else
    substep_pass_tile<3>(xy, stat, prev, follow, params, aux, out_xy, out_prev,
                         g, lanes, k, fresh_mask, cohesion, integrate, smem,
                         &n_listed);
}

}  // namespace

extern "C" int egg_substep_pass(const float* xy, const float* stat,
                                const float* prev, const float* follow,
                                const float* params, const float* aux,
                                const int* wide_flag, float* out_xy,
                                float* out_prev, int g, int lanes, int k,
                                int window, int fresh_mask, int cohesion,
                                int integrate, cudaStream_t stream) {
  const egg::TileLaunch at = egg::tile_launch(
      g, lanes, k, window, fresh_mask, wide_flag != nullptr, 6);
  const cudaError_t err = egg::tile_allow_smem(substep_pass_kernel, at.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  substep_pass_kernel<<<at.grid, at.threads, at.smem, stream>>>(
      xy, stat, prev, follow, params, aux, wide_flag, out_xy, out_prev, g,
      lanes, k, window, fresh_mask, cohesion, integrate);
  return static_cast<int>(cudaGetLastError());
}
