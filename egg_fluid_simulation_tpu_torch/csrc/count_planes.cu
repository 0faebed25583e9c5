// Kernel F: the examined-pair count of the ordered collision budget.
//
// Replaces: egg_fluid_simulation_tpu/ops/pallas/sweep_kernel.py
//           (_count_pallas: _make_kernel / _pair_terms with count_only).
//
// Layout: planes (8, G + 2*ROW_PAD, L) float32 (see sweep_planes.cu). Output
// (G, L) float32: for each occupied real slot, the number of occupied slots
// in its 3x3-cell neighbourhood (partner rows r + dy, dy in [-1, 1], read
// through the halo rows; partner lanes (l - d) mod L within +-1 cell column)
// whose FIELD_IDX is larger than its own, i.e. the pairs first examined at
// that particle in the reference's particle-ordered pair loop. Empty slots
// write 0. The counts are small integers, exact in float32, so the kernel
// equals its plain version bit for bit whatever the order.
//
// Design (sweep_tile.cuh, the tile of kernels B, D and E at window 1): a
// block owns 8 rows x 128 lanes (whole cells, 256 threads), lists the tile's
// occupied slots from FIELD_OCC and writes the zeros of the empty ones; a
// tile with none ends there. Otherwise it stages the tile with a 1-row,
// 1-cell halo, resolving the lane wrap once per staged slot, as ONE key a
// slot: FIELD_IDX where the slot is occupied, -inf where it is not. A
// partner counts where its key is larger than the self slot's, which is the
// plain version's test (occupied and a larger index) for every input: -inf
// is larger than nothing, and a NaN index compares false in both. The self
// slot's own key is not larger than itself, so the walk needs no exception
// for it. At K = 4 the staged keys take 10 x 136 x 4 = 5.4 KB and the list
// 2 KB. Each listed slot then compares the 3 x 3K keys of its three partner
// rows at fixed shared-memory offsets: no wrap, no lane mask and no global
// load in the loop.
// Bound on the H100: bytes. The function reads two fields of the real rows
// and one halo row on each side and writes one float a slot (28 MB at
// G = 768, K = 4: 8.5 us at 3.35 TB/s); the kernel reads FIELD_OCC of every
// slot once to list, and the two fields of the occupied staged slots of a
// tile that holds one (the halo reads of neighbouring tiles mostly hit L2).
// Measured on the 1M scene: 0.037 ms a launch, of which listing and staging
// take 0.026 and the walk the rest (PERF.md); the reads run at about a
// third of the card's memory rate.
//
// Ablation build (-DEGG_SWEEP_NO_COMPACT, profile_torch_sweeps.py): every
// slot of the tile is listed and staged, an empty self slot tests its
// occupancy in the walk.

#include "sweep_tile.cuh"

namespace {

using namespace egg;

__global__ void __launch_bounds__(kTileThreads) count_planes_kernel(
    const float* __restrict__ P, float* __restrict__ out, int g, int lanes,
    int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_listed;
  const Tile t = make_tile(1, 0, k);
  const int plane_rows = g + 2 * kRowPad;
  const long long F = static_cast<long long>(plane_rows) * lanes;
  auto occ_at = [&](int r, int l) {
    return P[kOcc * F + static_cast<long long>(r + kRowPad) * lanes + l];
  };

  unsigned short* list = reinterpret_cast<unsigned short*>(smem);
  const int n_list = tile_compact(
      t, g, lanes, list, &n_listed, occ_at,
      [&](int r, int l) { out[static_cast<long long>(r) * lanes + l] = 0.0f; });
  if (n_list == 0) return;

  // ---- stage one key a slot: the tile's rows and one halo row on each
  // side (plane rows, so the torus in y is the halo the planes carry), one
  // cell of lanes on each side, wrapped
  float* key = reinterpret_cast<float*>(smem + tile_list_bytes(t.tl, t.tr));
  for (int i = threadIdx.x; i < t.n_stage; i += blockDim.x) {
    const int srow = i / t.sw;
    const int prow = t.r0 - 1 + srow + kRowPad;
    const int pl = wrap_any(t.l0 - t.hl + (i - srow * t.sw), lanes);
    float v = -__int_as_float(0x7f800000);  // -inf
    if (prow < plane_rows) {  // rows past the planes serve no real slot
      const long long o = static_cast<long long>(prow) * lanes + pl;
      if (P[kOcc * F + o] > 0.0f) v = P[kIdx * F + o];
    }
    key[i] = v;
  }
  __syncthreads();

  // ---- each listed slot: partners of larger key among the 3 x 3K staged
  // slots of its three partner rows (cells cx - 1 .. cx + 1)
  const int n_partner_lanes = 3 * k;
  for (int j = threadIdx.x; j < n_list; j += blockDim.x) {
    const int i = list[j];
    const int trow = i / t.tl;
    const int tlane = i - trow * t.tl;
    const long long idx =
        static_cast<long long>(t.r0 + trow) * lanes + t.l0 + tlane;
    if (!kCompact && !(occ_at(t.r0 + trow, t.l0 + tlane) > 0.0f)) {
      out[idx] = 0.0f;
      continue;
    }
    const float skey = key[(trow + 1) * t.sw + tlane + t.hl];
    const int pl_lo = (tlane / k) * k;  // staged lane, cell cx - 1 slot 0
    int total = 0;
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const float* row = key + (trow + dy) * t.sw + pl_lo;
      for (int q = 0; q < n_partner_lanes; ++q) total += row[q] > skey;
    }
    out[idx] = static_cast<float>(total);
  }
}

}  // namespace

extern "C" int egg_count_planes(const float* planes, float* out, int g,
                                int lanes, int k, cudaStream_t stream) {
  // one staged key a slot at window 1, no fresh cells
  const egg::TileLaunch at = egg::tile_launch(g, lanes, k, 1, 0, false, 1);
  count_planes_kernel<<<at.grid, at.threads, at.smem, stream>>>(planes, out,
                                                                 g, lanes, k);
  return static_cast<int>(cudaGetLastError());
}
