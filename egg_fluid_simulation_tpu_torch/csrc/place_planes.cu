// Kernel A: place cell-sorted particle payloads into the dense field planes.
//
// Replaces: egg_fluid_simulation_tpu/ops/pallas/place_kernel.py
//           (_place_pallas / _make_kernel / _place_chunk), the TPU's
//           one-hot-matmul stand-in for the scatter in ops/dense.py
//           (bin_to_planes, the golden model).
//
// What it computes: planes (F, G + 2*ROW_PAD, L) float32 where, for every
// sorted entry j whose slot s = slot_sorted[j] is a real slot (s < G*L),
// planes[f, ROW_PAD + s / L, s % L] = pack[pidx_sorted[j], f] for all fields
// f, every other real slot is 0, and the torus halo rows hold copies of the
// opposite edge rows (ops/dense.fill_halo). Slots are unique by construction
// (the cell rank makes them so). The inputs are the cell sort's
// (ops/dense.sort_bin): cell_sorted (the entries' cell ids, ascending;
// G*G or more for inactive entries, at the tail), slot_sorted (G*L for an
// entry past its cell's K slots, which sits inside its cell's run) and
// pidx_sorted (the particle of each entry), and pack (N, F), the payload in
// particle order. An in-budget entry's slot lies in its cell:
// slot = cell * K + rank.
//
// Design: a block owns a chunk of whole cells, 512 slots at K = 1, 2, 4, 8
// (the chunk the TPU kernel used), and writes every output element of its
// slots exactly once, halo copies included, so nothing is zero-filled
// first:
// - two warps find the chunk's run of entries [lo, hi), the entries whose
//   cell lies in the chunk, by a 32-way search of cell_sorted (4 rounds of
//   one load a lane at N = 2^20); the run is contiguous in the sorted order
//   because the sort is by cell, with rotate=True too, where the rank only
//   permutes slots inside a cell;
// - the block walks the run, a thread an entry, however long its cells'
//   overflow makes it, and copies each in-budget entry's payload row, read
//   through pidx_sorted (the gather the caller would otherwise
//   materialise), into a shared-memory buffer indexed by the entry's slot
//   in the chunk; the fields of a row are loaded together before any is
//   stored, so a block waits on two rounds to memory (index, row) for
//   every 256 entries; over-budget entries are skipped. A byte a slot marks
//   the slots that received a row;
// - then each thread takes slots of the chunk and writes, field by field,
//   the row or 0 to the core row and, for the first and last ROW_PAD real
//   rows, to its halo mirror (g >= 2 * ROW_PAD, so each core row has at
//   most one mirror and each halo row is one core row's mirror); a warp's
//   stores of one field are 32 consecutive floats.
// Shared memory: 512 slots x F floats + 512 bytes (27 KB at F = 13).
// Bound on the H100: memory. The output (125 MB at G = 768, K = 4, F = 13)
// is most of the bytes; the payload rows (52 MB), the slots and the
// particle indices (8 MB each) are read once; the cell ids only where the
// searches probe them. Measured on the 1M scene: 0.142 ms a launch, of
// which the stores alone take 0.042 and the rows read in entry order
// instead of through pidx_sorted 0.078: the gather of 52-byte rows in
// particle order (a random walk over the payload) is what the rest costs
// (PERF.md).
//
// Bit-exact by construction (pure copies). Built without --use_fast_math;
// nothing here would change under it, but the library's other kernels need
// IEEE expf, rsqrtf and division, and all of them share one build.
//
// Ablation build (-DEGG_PLACE_WRITE_ONLY, profile_torch_sweeps.py): no
// search and no staging, every slot written as empty: the store floor.

#include <cuda_runtime.h>

namespace {

constexpr int kChunkSlots = 512;   // slots of a block, rounded down to cells
constexpr int kThreads = 256;
constexpr int kFieldBatch = 16;    // payload fields a thread loads at once

#ifdef EGG_PLACE_WRITE_ONLY
constexpr bool kStage = false;
#else
constexpr bool kStage = true;
#endif

// The first i in [lo, hi) with key[i] >= target, or hi; called by all 32
// lanes of a warp. Each round probes 32 evenly spaced entries and keeps the
// gap before the first that reaches the target: the length falls from len
// to at most ceil(len / 32) - 1.
__device__ int warp_lower_bound(const long long* __restrict__ key, int lo,
                                int hi, long long target) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const long long q = lo + static_cast<long long>(lane) * step;
    const bool reached = q >= hi || key[q] >= target;
    const unsigned ballot = __ballot_sync(0xffffffffu, reached);
    const int first = ballot != 0u ? __ffs(static_cast<int>(ballot)) - 1 : 32;
    if (first == 0) return lo;
    const long long end = lo + static_cast<long long>(first) * step;
    lo = lo + (first - 1) * step + 1;
    hi = end < hi ? static_cast<int>(end) : hi;
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) place_planes_kernel(
    const long long* __restrict__ cell_sorted,
    const long long* __restrict__ slot_sorted,
    const long long* __restrict__ pidx_sorted,
    const float* __restrict__ pack, float* __restrict__ out, int n,
    int n_fields, int g, int lanes, int k, int row_pad, int chunk_cells) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int run[2];
  const int chunk_slots = chunk_cells * k;
  float* buf = reinterpret_cast<float*>(smem);   // chunk_slots x n_fields
  unsigned char* filled = smem + static_cast<size_t>(chunk_slots) * n_fields *
                                     sizeof(float);
  const long long n_cells = static_cast<long long>(g) * g;
  const long long c0 = static_cast<long long>(blockIdx.x) * chunk_cells;
  const long long c1 =
      c0 + chunk_cells < n_cells ? c0 + chunk_cells : n_cells;
  const long long s0 = c0 * k;               // the chunk's first slot
  const int n_slots = static_cast<int>((c1 - c0) * k);

  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) filled[i] = 0;
  if (kStage) {
    // ---- the run of entries whose cell lies in [c0, c1)
    const int warp = static_cast<int>(threadIdx.x >> 5);
    if (warp < 2) {
      const int at = warp_lower_bound(cell_sorted, 0, n, warp == 0 ? c0 : c1);
      if ((threadIdx.x & 31u) == 0u) run[warp] = at;
    }
    __syncthreads();

    // ---- stage the in-budget entries' rows by slot: a thread an entry,
    // its slot and particle loaded together, then kFieldBatch fields of the
    // row loaded before any is stored, so the loads of a row overlap
    const int lo = run[0], hi = run[1];
    const long long total = static_cast<long long>(g) * lanes;
    for (int j = lo + static_cast<int>(threadIdx.x); j < hi;
         j += blockDim.x) {
      const long long s = slot_sorted[j];
      const long long p = pidx_sorted[j];
      const long long local = s - s0;
      if (!(s < total && local >= 0 && local < n_slots)) continue;
      const float* row = pack + p * n_fields;
      float* dst = buf + local * n_fields;
      for (int f0 = 0; f0 < n_fields; f0 += kFieldBatch) {
        float v[kFieldBatch];
#pragma unroll
        for (int f = 0; f < kFieldBatch; ++f)
          if (f0 + f < n_fields) v[f] = row[f0 + f];
#pragma unroll
        for (int f = 0; f < kFieldBatch; ++f)
          if (f0 + f < n_fields) dst[f0 + f] = v[f];
      }
      filled[local] = 1;
    }
  }
  __syncthreads();

  // ---- write every slot of the chunk once, and its halo mirror
  const long long plane = static_cast<long long>(g + 2 * row_pad) * lanes;
  const long long wrap = static_cast<long long>(g) * lanes;
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    const long long s = s0 + i;
    const int r = static_cast<int>(s / lanes);
    const long long at = s + static_cast<long long>(row_pad) * lanes;
    long long at_halo = -1;
    if (r >= g - row_pad) {
      at_halo = at - wrap;    // top halo: mirrors the last real rows
    } else if (r < row_pad) {
      at_halo = at + wrap;    // bottom halo: mirrors the first real rows
    }
    const bool has = filled[i] != 0;
    const float* src = buf + static_cast<size_t>(i) * n_fields;
    for (int f = 0; f < n_fields; ++f) {
      const float v = has ? src[f] : 0.0f;
      out[f * plane + at] = v;
      if (at_halo >= 0) out[f * plane + at_halo] = v;
    }
  }
}

}  // namespace

extern "C" int egg_place_planes(const long long* cell_sorted,
                                const long long* slot_sorted,
                                const long long* pidx_sorted,
                                const float* pack, float* out, int n,
                                int n_fields, int g, int lanes, int k,
                                int row_pad, cudaStream_t stream) {
  const int chunk_cells = kChunkSlots / k > 0 ? kChunkSlots / k : 1;
  const long long n_cells = static_cast<long long>(g) * g;
  const long long blocks = (n_cells + chunk_cells - 1) / chunk_cells;
  const size_t smem = static_cast<size_t>(chunk_cells) * k *
                      (n_fields * sizeof(float) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        place_planes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  place_planes_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        stream>>>(cell_sorted, slot_sorted, pidx_sorted, pack,
                                  out, n, n_fields, g, lanes, k, row_pad,
                                  chunk_cells);
  return static_cast<int>(cudaGetLastError());
}
