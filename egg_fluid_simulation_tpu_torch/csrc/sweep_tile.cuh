// The shared-memory tile of the tiled sweeps (kernels B, D and E).
//
// A block owns a tile of `tr` rows x `tl` lanes of the (G, L = G*K) slot
// grid; `tl` is a multiple of K, so a tile starts and ends on a cell border
// and the partners of its slots lie within `w` rows and `w` cells of it. The
// block stages the tile with that halo, (tr + 2w) x (tl + 2wK) slots, into
// shared memory once, field by field (one float array per field, the staged
// slots row-major), and resolves the torus wrap once per staged slot; the
// pair loop then reads partners at fixed offsets from the self slot, with no
// wrap, no lane mask and no global load. The half-space sweep (kernel E)
// looks only at rows r .. r + w, so its tile has no halo rows above:
// (tr + w) x (tl + 2wK) staged slots (`half_space`).
//
// The dynamic shared memory of a block holds, in this order: the list of
// the tile's occupied slots (unsigned short, tr * tl entries) and the staged
// fields. With a device-side window flag the launch is sized for the widest
// window the flag can select and the block lays out only the halo in force.

#pragma once

#include "pair_terms.cuh"

namespace egg {

constexpr int kTileRows = 8;        // rows of a tile
constexpr int kTileLanes = 128;     // lanes of a tile, rounded down to cells
// Threads of a block; they walk the tile in strides. A launch that may run
// window 3 stages 2-2.6x the shared memory a block, so fewer blocks fit an
// SM and each brings more threads (256 / 512 measured fastest among 128 to
// 1024 at both windows on the H100).
constexpr int kTileThreads = 256;
constexpr int kTileThreadsWide = 512;

// Ablation build (-DEGG_SWEEP_NO_COMPACT, used by profile_torch_sweeps.py):
// staging alone. Every slot of the tile is listed, empty self slots are met
// in the pair loop, and an empty tile is staged like any other.
#ifdef EGG_SWEEP_NO_COMPACT
constexpr bool kCompact = false;
#else
constexpr bool kCompact = true;
#endif

struct Tile {
  int w, fresh;   // the window in force and its fresh-cell mask
  int tl, tr;     // lanes and rows of the tile
  int hl;         // lane halo on each side: w * k
  int ha;         // halo rows above the tile: w, or 0 for the half-space sweep
  int sw, sr;     // staged lanes and rows
  int n_stage;    // staged slots = the stride between staged fields
  int l0, r0;     // the tile's first lane and row in the grid
};

// lanes of a tile: whole cells, about kTileLanes
__host__ __device__ inline int tile_lanes(int k) {
  return (kTileLanes / k > 0 ? kTileLanes / k : 1) * k;
}

__host__ __device__ inline size_t tile_list_bytes(int tl, int tr) {
  return (static_cast<size_t>(tl) * tr * sizeof(unsigned short) + 15) / 16 * 16;
}

// dynamic shared memory of a block that stages `n_fields` fields at window w
__host__ inline size_t tile_smem_bytes(int k, int w, int n_fields,
                                       bool half_space) {
  const int tl = tile_lanes(k);
  const size_t staged =
      static_cast<size_t>(kTileRows + (half_space ? w : 2 * w)) *
      (tl + 2 * w * k);
  return tile_list_bytes(tl, kTileRows) + staged * n_fields * sizeof(float);
}

// The launch shape of a tiled sweep over a (g, lanes) grid: one block a tile.
// With a device-side flag (`flagged`) the launch is sized for the widest
// window the flag selects, window 3 with the fresh cells staged.
struct TileLaunch {
  dim3 grid;
  int threads;
  size_t smem;
};

__host__ inline TileLaunch tile_launch(int g, int lanes, int k, int window,
                                       int fresh_mask, bool flagged,
                                       int n_fields,
                                       bool half_space = false) {
  const int w_max = flagged ? 3 : window;
  const bool fresh_max = flagged || fresh_mask != 0;
  const int tl = tile_lanes(k);
  TileLaunch s;
  s.grid = dim3((lanes + tl - 1) / tl, (g + kTileRows - 1) / kTileRows);
  s.threads = w_max > 1 ? kTileThreadsWide : kTileThreads;
  s.smem = tile_smem_bytes(k, w_max, n_fields + (fresh_max ? 2 : 0),
                           half_space);
  return s;
}

// Shared memory above 48 KB a block has to be asked for, kernel by kernel.
template <typename Kernel>
__host__ inline cudaError_t tile_allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The window in force: `wide_flag`, where given, selects window 3 with the
// fresh-cell mask (nonzero) or window 1 (zero); the block reads it once.
__device__ __forceinline__ void window_in_force(const int* wide_flag,
                                                int* window, int* fresh_mask) {
  if (wide_flag != nullptr) {
    const bool wide = *wide_flag != 0;
    *window = wide ? 3 : 1;
    *fresh_mask = wide ? 1 : 0;
  }
}

// The block's tile at window w.
__device__ __forceinline__ Tile make_tile(int w, int fresh, int k,
                                          bool half_space = false) {
  Tile t;
  t.w = w;
  t.fresh = fresh;
  t.tl = tile_lanes(k);
  t.tr = kTileRows;
  t.hl = t.w * k;
  t.sw = t.tl + 2 * t.hl;
  t.ha = half_space ? 0 : t.w;
  t.sr = t.tr + t.ha + t.w;
  t.n_stage = t.sw * t.sr;
  t.l0 = blockIdx.x * t.tl;
  t.r0 = blockIdx.y * t.tr;
  return t;
}

// torus_adjacent of two fresh cells. Where the modulus fm is a whole number
// in [1, 2^22) (`whole`), the cells are whole numbers in [0, fm) and every
// step of torus_adjacent is exact, so it is true exactly when a - b is 0,
// +-1 or +-(fm - 1): the same answer without the fmodf.
__device__ __forceinline__ bool whole_modulus(float fm) {
  return fm == floorf(fm) && fm >= 1.0f && fm < 4194304.0f;
}

__device__ __forceinline__ bool cells_adjacent(float a, float b, float fm,
                                               bool whole) {
  if (!whole) return torus_adjacent(a, b, fm);
  const float e = fabsf(a - b);
  return e <= 1.0f || e == fm - 1.0f;
}

// i mod n for any i (a tile and its halo may span a small grid many times)
__device__ __forceinline__ int wrap_any(int i, int n) {
  while (i < 0) i += n;
  while (i >= n) i -= n;
  return i;
}

// Builds the list of the tile's slots that lie inside the grid and whose
// occupancy `occ_at(row, lane)` is positive, in `list` (tile slot indices
// row * tl + lane; a warp's 32 slots stay together), and calls
// `write_empty(row, lane)` for every in-grid slot that is not occupied.
// Returns the number of listed slots to every thread. `counter` is one int
// of static shared memory.
template <typename OccAt, typename WriteEmpty>
__device__ __forceinline__ int tile_compact(const Tile& t, int g, int lanes,
                                            unsigned short* list, int* counter,
                                            OccAt occ_at,
                                            WriteEmpty write_empty) {
  if (threadIdx.x == 0) *counter = 0;
  __syncthreads();
  const int n = t.tl * t.tr;
  const unsigned lane_id = threadIdx.x & 31u;
  for (int base = 0; base < n; base += blockDim.x) {
    const int i = base + threadIdx.x;
    bool occupied = false;
    if (i < n) {
      const int trow = i / t.tl;
      const int r = t.r0 + trow;
      const int l = t.l0 + i - trow * t.tl;
      if (r < g && l < lanes) {
        occupied = !kCompact || occ_at(r, l) > 0.0f;
        if (!occupied) write_empty(r, l);
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, occupied);
    int at = 0;
    if (lane_id == 0 && ballot != 0u) at = atomicAdd(counter, __popc(ballot));
    at = __shfl_sync(0xffffffffu, at, 0);
    if (occupied)
      list[at + __popc(ballot & ((1u << lane_id) - 1u))] =
          static_cast<unsigned short>(i);
  }
  __syncthreads();
  return *counter;
}

}  // namespace egg
