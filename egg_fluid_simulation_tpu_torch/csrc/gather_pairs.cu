// Kernel H: the gather engine's collision pass. Three launches a pass:
// gather_front (the particle record and the hash bucket, before the sort
// that builds the slot table), gather_count (the ordered budget's
// per-particle pair count) and gather_sweep (one Jacobi pair pass of a
// population on its hash grid).
//
// Replaces: no TPU kernel. In the JAX package XLA fuses solve_pairs
//           (egg_fluid_simulation_tpu/ops/solver.py) by itself; H replaces
//           the port's plain PyTorch form of it (ops/kernels/gather_kernel.py:
//           gather_front_plain, gather_sweep_plain, gather_count_plain), a
//           few hundred small ops on (N, 9K) candidate arrays a pass, and
//           the front of ops/grid.build_grid (cell coords, bucket hash).
//
// The record: 32 bytes a particle, two 16-byte vectors,
//   (x, y, inv_mass, radius) as float32 and
//   (cell_x, cell_y, batch, active) as int32 (stored as their bits),
// with cell = (int)floor(pos / cell_size) (IEEE division, floorf, the
// saturating conversion PyTorch's CUDA cast uses), written by gather_front
// together with bucket = active ? ((cx * 0x9E3779B1) ^ (cy * 0x85EBCA77))
// mod table_size : table_size in uint32 arithmetic (bit-identical to
// grid._bucket_of's masked products and build_grid's where).
//
// What the count and the sweep compute, per particle p (a table of
// table_size buckets of K slots, -1 = empty; the grid of ops/grid):
// - the nine buckets of p's 3x3 cells, a bucket repeated within the nine
//   visited once (grid.neighbor_candidates);
// - the candidates c of those buckets' slots with c >= 0, c != p, p live,
//   and the TRUE 3x3 cell test |cell(c) - cell(p)| <= 1 in x and y (int32,
//   wrapping, as the plain version's int32 tensors compute it);
// - gather_count: new_pairs[p] = the candidates with c > p, as float32;
// - gather_sweep: with w_sum = w_p + w_c >= EPS and, under the ordered
//   budget, cum[min(p, c)] < max_pairs, the collision term (dist^2 <=
//   (overlap * r_sum)^2) and, in the "spacing" cohesion mode, the
//   same-batch cohesion term (dist^2 <= (coh_factor * r_sum)^2), each
//   -(dist - target) / (w_sum + compliance) clamped to +-|dist - target|,
//   times w_p; the pair's push -(d * inv_dist) * scale summed over the
//   candidates; out = pos[p] + (active[p] ? relaxation * total : 0).
//   An owned range (offset, count) sweeps particles offset + i of the
//   record (the particle-sharded step's local slice) into out[i].
// - the budget's cut counter (optional, the solver's pass of a population:
//   int32 {cut passes, budgeted passes, last cut pass}): the count adds one
//   to the budgeted passes (one thread), and the sweep adds one to the cut
//   passes when some pair in the true 3x3 cells fails cum[min(p, c)] <
//   max_pairs: the first lane of each warp that meets such a pair raises
//   the last cut pass to the pass's number with one atomicMax, and the
//   lane that raised it counts the pass. Nothing in the step reads it.
//   The per-pair arithmetic is the plain version's op for op (the library
//   builds with --fmad=false, IEEE '/' and sqrtf), so a pair's term rounds
//   alike; the sum runs in another order (a lane's candidates, then a
//   shuffle tree), so totals agree to rounding.
//
// Bound on the H100: instructions and latency, not bytes. At the gather
// engine's sizes (N <= 16384) the records take 512 KB and the table 1 MB,
// all in L2; the bytes and the pair arithmetic of a pass take well under
// a microsecond (chip_smoke.py check.gather_pairs prints both bounds and
// an empty kernel's time). What costs is the chain of dependent loads
// (the particle's record, its table slots, its candidates' records), the
// index arithmetic each lane repeats, and lanes idling in divergent pair
// arithmetic. The design:
// - a group of L lanes owns a particle (16 in the sweep, 8 in the count:
//   the fastest of 8, 16 and 32 for each at K = 16 and K = 4 on an H100);
//   its 9K (row, slot) items are dealt to the lanes in batches of nine a
//   lane (item i = batch * 9L + t * L + lane, row i / K, slot i % K), so
//   at K = L a lane holds slot `lane` of each of the nine rows. K = 4, 8,
//   16 and 32 are compiled in (K >= L: each item's row is a constant, its
//   bucket a register), any other K runs the same code with K read at run
//   time;
// - a lane issues the nine slot loads of a batch before it uses any, then
//   the nine candidates' cell loads (half a record) and, under the budget,
//   the nine cum loads together; an empty or masked slot loads the
//   particle's own record (an L1 hit) instead of branching. The loops are
//   unrolled, so all of it stays in registers;
// - the sweep lists the batch's candidates that pass the cell test and
//   the budget in shared memory (a ballot a row gives each its place, in
//   row-then-lane order), and the group's lanes then take the list's
//   entries in turn for the pair arithmetic (the fields are the other
//   half of the record the cell load brought into L1): a lane runs the
//   arithmetic about once a batch instead of once per row that any lane
//   of its warp needs;
// - one record load gives a candidate's cell, batch and fields: before
//   the record, a candidate was a cell load and then eight scalar loads
//   from six arrays.
// Each particle writes its own output: a Jacobi pass sums only its own
// side of each pair, so nothing is atomic, and the group's partial sums
// meet in a fixed shuffle tree (deterministic run to run). Group g takes
// particle g (offset + g in an owned range): taking the particles in the
// grid's bucket-sorted order instead measured no faster on an H100 (every
// table row is in L2).
//
// Built without --use_fast_math (IEEE division and sqrt), as the rest of
// the library.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;    // a block: 256 / L particles
constexpr int kSweepLanes = 16;  // L, lanes a particle, of the sweep
constexpr int kCountLanes = 8;   // and of the count
constexpr int kRows = 9;         // the 3x3 cells
constexpr float kEps = 1e-8f;    // utils/mathx.EPS
constexpr unsigned kHashX = 0x9E3779B1u;
constexpr unsigned kHashY = 0x85EBCA77u;

__device__ __forceinline__ int bucket_of(int cx, int cy, int dx, int dy,
                                         unsigned mask) {
  const unsigned ux = static_cast<unsigned>(cx) + static_cast<unsigned>(dx);
  const unsigned uy = static_cast<unsigned>(cy) + static_cast<unsigned>(dy);
  return static_cast<int>(((ux * kHashX) ^ (uy * kHashY)) & mask);
}

// |a - b| <= 1 on int32 with two's-complement wrap, as torch.abs of an
// int32 difference computes it (abs(INT_MIN) stays INT_MIN, which passes).
__device__ __forceinline__ bool adjacent(int a, int b) {
  const unsigned d = static_cast<unsigned>(a) - static_cast<unsigned>(b);
  const unsigned ad = static_cast<int>(d) < 0 ? 0u - d : d;
  return static_cast<int>(ad) <= 1;
}

// Bucket b (0..8) of the 3x3 cells around (cx, cy), in NEIGHBOR_OFFSETS
// order (dx outer, dy inner).
__device__ __forceinline__ int nth_bucket(int cx, int cy, int b,
                                          unsigned mask) {
  return bucket_of(cx, cy, b / 3 - 1, b % 3 - 1, mask);
}

// The nine buckets (in registers: every index is a constant once the
// loops are unrolled) and a bit per bucket that repeats an earlier one.
__device__ __forceinline__ unsigned repeated_buckets(int cx, int cy,
                                                     unsigned mask,
                                                     int (&bucket)[kRows]) {
  unsigned repeated = 0u;
#pragma unroll
  for (int b = 0; b < kRows; ++b) {
    bucket[b] = nth_bucket(cx, cy, b, mask);
#pragma unroll
    for (int e = 0; e < b; ++e) {
      if (bucket[e] == bucket[b]) repeated |= 1u << b;
    }
  }
  return repeated;
}

template <int L, typename T>
__device__ __forceinline__ T group_sum(T v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, L);
  return v;
}

__device__ __forceinline__ float4 fields_of(const float4* rec, int i) {
  return __ldg(rec + 2 * i);
}

__device__ __forceinline__ int4 cells_of(const float4* rec, int i) {
  return __ldg(reinterpret_cast<const int4*>(rec) + 2 * i + 1);
}

// |correction| * w_self of _enforce_distance: the plain version's
// half_scale for a pair that fires.
__device__ __forceinline__ float half_scale(float dist, float target,
                                            float w_sum, float compliance,
                                            float w_self) {
  const float violation = dist - target;
  float corr = -violation / (w_sum + compliance);
  const float bound = fabsf(violation);
  corr = fminf(fmaxf(corr, -bound), bound);
  return corr * w_self;
}

// Item `base + t * L + lane` of a particle's 9K (row, slot) items: its
// row and slot, and whether it exists (< 9K). With K >= L (both powers of
// two) the row is a compile-time constant once the loops are unrolled.
template <int L, int K>
__device__ __forceinline__ void item_of(int base, int t, int lane, int k,
                                        int& row, int& slot, bool& in) {
  const int ib = base + t * L;
  if constexpr (K >= L) {
    row = ib / K;
    slot = ib % K + lane;
    in = ib < kRows * K;
  } else {
    const int kk = K > 0 ? K : k;
    const int i = ib + lane;
    in = i < kRows * kk;
    row = in ? i / kk : 0;
    slot = in ? i - row * kk : 0;
  }
}

// The nine slots of batch `base` of a lane: c[t] = table slot of item
// base + t * L + lane, or -1 where the item does not exist, its row
// repeats an earlier bucket or the particle is not live. Every load is
// issued before any is used.
template <int L, int K>
__device__ __forceinline__ void batch_slots(const int* __restrict__ table,
                                            const int (&bucket)[kRows],
                                            int cx, int cy, unsigned mask,
                                            unsigned repeated, bool live,
                                            int k, int base, int lane,
                                            int (&c)[kRows]) {
  const int kk = K > 0 ? K : k;
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    int row, slot;
    bool in;
    item_of<L, K>(base, t, lane, k, row, slot, in);
    int b;
    if constexpr (K >= L) {
      b = bucket[row];
    } else {
      b = nth_bucket(cx, cy, row, mask);
    }
    const int v = __ldg(table + static_cast<long long>(b) * kk + slot);
    c[t] = (live && in && !((repeated >> row) & 1u)) ? v : -1;
  }
}

// Calls body(base) for each batch of a particle's items: unrolled when K
// is compiled in.
template <int L, int K, typename Body>
__device__ __forceinline__ void for_batches(int k, Body body) {
  if constexpr (K > 0) {
#pragma unroll
    for (int b = 0; b < (K + L - 1) / L; ++b) body(b * kRows * L);
  } else {
#pragma unroll 1
    for (int base = 0; base < kRows * k; base += kRows * L) body(base);
  }
}

__global__ void __launch_bounds__(kThreads)
gather_front_kernel(const float2* __restrict__ pos,
                    const float* __restrict__ inv_mass,
                    const float* __restrict__ radius,
                    const int* __restrict__ batch,
                    const unsigned char* __restrict__ active,
                    const float* __restrict__ cell_size,
                    float4* __restrict__ record, int* __restrict__ bucket,
                    int n, int table_size) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  const float2 xy = pos[p];
  const float cs = *cell_size;
  const int cx = static_cast<int>(floorf(xy.x / cs));
  const int cy = static_cast<int>(floorf(xy.y / cs));
  const bool live = active[p] != 0;
  const unsigned mask = static_cast<unsigned>(table_size - 1);
  bucket[p] = live ? bucket_of(cx, cy, 0, 0, mask) : table_size;
  record[2 * p] = make_float4(xy.x, xy.y, inv_mass[p], radius[p]);
  reinterpret_cast<int4*>(record)[2 * p + 1] =
      make_int4(cx, cy, batch[p], live ? 1 : 0);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
gather_count_kernel(const float4* __restrict__ rec,
                    const int* __restrict__ table, float* __restrict__ out,
                    int n, int table_size, int k, int* __restrict__ cuts) {
  constexpr int L = kCountLanes;
  // the budgeted pass's number: the sweep after this count reads it
  if (cuts != nullptr && blockIdx.x == 0 && threadIdx.x == 0) cuts[1] += 1;
  const int g = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const int lane = threadIdx.x % L;
  const bool in_range = g < n;
  const int p = in_range ? g : 0;
  const int4 me = in_range ? cells_of(rec, p) : make_int4(0, 0, 0, 0);
  const bool live = me.w != 0;
  const int cx = me.x, cy = me.y;
  const unsigned mask = static_cast<unsigned>(table_size - 1);
  int bucket[kRows];
  const unsigned repeated = repeated_buckets(cx, cy, mask, bucket);
  int count = 0;
  if (live) for_batches<L, K>(k, [&](int base) {
    int c[kRows];
    batch_slots<L, K>(table, bucket, cx, cy, mask, repeated, live, k, base,
                      lane, c);
    int4 o[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) o[t] = cells_of(rec, c[t] > p ? c[t] : p);
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      // later particles only (empty, itself and earlier ones excluded)
      if (c[t] > p && adjacent(o[t].x, cx) && adjacent(o[t].y, cy)) ++count;
    }
  });
  count = group_sum<L>(count);
  if (lane == 0 && in_range) out[p] = static_cast<float>(count);
}

struct SweepScalars {
  const float* max_pairs;   // null: budget off
  const float* collision_c;
  const float* cohesion_c;
  const float* overlap;
  const float* coh_factor;
  const float* relaxation;
};

template <int K>
__global__ void __launch_bounds__(kThreads)
gather_sweep_kernel(const float4* __restrict__ rec,
                    const int* __restrict__ table,
                    const float* __restrict__ cum, SweepScalars sc,
                    float2* __restrict__ out, int n_groups, int offset,
                    int table_size, int k, int spacing, int* cuts) {
  constexpr int L = kSweepLanes;
  // a group's list of the batch's candidates that pass the cell test and
  // the budget: at most 9 a lane
  __shared__ int s_list[kThreads / L][kRows * L];
  const int gi = threadIdx.x / L;
  const int g = blockIdx.x * (kThreads / L) + gi;
  const int lane = threadIdx.x % L;
  const unsigned wl = threadIdx.x & 31u;
  const unsigned group_mask =
      L == 32 ? 0xffffffffu : ((1u << (L & 31)) - 1u) << (wl & ~(L - 1u));
  const unsigned below = (1u << wl) - 1u;
  const bool in_range = g < n_groups;
  const int p = in_range ? offset + g : 0;
  const float4 me = in_range ? fields_of(rec, p) : make_float4(0, 0, 0, 0);
  const int4 mc = in_range ? cells_of(rec, p) : make_int4(0, 0, 0, 0);
  const bool live = mc.w != 0;
  const float sx = me.x, sy = me.y, sw = me.z, sr = me.w;
  const int cx = mc.x, cy = mc.y, sb = mc.z;
  const bool ordered = sc.max_pairs != nullptr;
  const float max_pairs = ordered ? *sc.max_pairs : 0.0f;
  const float collision_c = *sc.collision_c, cohesion_c = *sc.cohesion_c;
  const float overlap = *sc.overlap, coh_factor = *sc.coh_factor;
  const unsigned mask = static_cast<unsigned>(table_size - 1);
  int bucket[kRows];
  const unsigned repeated = repeated_buckets(cx, cy, mask, bucket);
  int* list = s_list[gi];
  float tx = 0.0f, ty = 0.0f;
  bool cut = false;   // a pair in the true cells the budget leaves out
  // a warp with no live particle (the inactive tail) skips the walk
  if (__any_sync(0xffffffffu, live)) for_batches<L, K>(k, [&](int base) {
    int c[kRows];
    batch_slots<L, K>(table, bucket, cx, cy, mask, repeated, live, k, base,
                      lane, c);
    int4 o[kRows];
    float cum_min[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const int ci = c[t] >= 0 && c[t] != p ? c[t] : p;
      o[t] = cells_of(rec, ci);
      cum_min[t] = ordered ? __ldg(cum + (ci < p ? ci : p)) : 0.0f;
    }
    int n_list = 0;
#pragma unroll
    for (int t = 0; t < kRows; ++t) {
      const bool near = c[t] >= 0 && c[t] != p && adjacent(o[t].x, cx) &&
                        adjacent(o[t].y, cy);
      const bool pair = near && (!ordered || cum_min[t] < max_pairs);
      cut = cut || (near && !pair);
      const unsigned vote = __ballot_sync(0xffffffffu, pair) & group_mask;
      if (pair) list[n_list + __popc(vote & below)] = c[t];
      n_list += __popc(vote);
    }
    __syncwarp();
    for (int j = lane; j < n_list; j += L) {
      const int cj = list[j];
      const float4 f = fields_of(rec, cj);
      const float w_sum = sw + f.z;
      if (!(w_sum >= kEps)) continue;                         // :1601
      const float dx = f.x - sx;
      const float dy = f.y - sy;
      const float dist2 = dx * dx + dy * dy;
      const float dist = sqrtf(dist2);
      const float inv_dist = dist > kEps ? 1.0f / fmaxf(dist, kEps) : 0.0f;
      const float r_sum = sr + f.w;
      const float min_dist = overlap * r_sum;                 // :1632-1654
      float scale = dist2 <= min_dist * min_dist
                        ? half_scale(dist, min_dist, w_sum, collision_c, sw)
                        : 0.0f;
      if (spacing) {                                          // :1603-1630
        const float coh_dist = coh_factor * r_sum;
        const float coh =
            cells_of(rec, cj).z == sb && dist2 <= coh_dist * coh_dist
                ? half_scale(dist, coh_dist, w_sum, cohesion_c, sw)
                : 0.0f;
        scale = coh + scale;
      }
      tx += -(dx * inv_dist) * scale;
      ty += -(dy * inv_dist) * scale;
    }
    __syncwarp();
  });
  tx = group_sum<L>(tx);
  ty = group_sum<L>(ty);
  if (cuts != nullptr) {
    const unsigned cut_lanes = __ballot_sync(0xffffffffu, cut);
    if (cut_lanes != 0u && wl == static_cast<unsigned>(__ffs(cut_lanes) - 1)) {
      const int pass = *reinterpret_cast<volatile int*>(cuts + 1);
      if (*reinterpret_cast<volatile int*>(cuts + 2) != pass &&
          atomicMax(cuts + 2, pass) < pass)
        atomicAdd(cuts, 1);
    }
  }
  if (lane == 0 && in_range) {
    const float relax = *sc.relaxation;
    out[g] = make_float2(me.x + (live ? relax * tx : 0.0f),
                         me.y + (live ? relax * ty : 0.0f));
  }
}

__global__ void empty_kernel() {}

unsigned blocks_for(int n, int lanes) {
  const int per_block = kThreads / lanes;
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

// The instances: K compiled in (0: read at run time).
template <int K>
int launch_count(const float4* rec, const int* table, float* out, int n,
                 int table_size, int k, int* cuts, cudaStream_t stream) {
  gather_count_kernel<K><<<blocks_for(n, kCountLanes), kThreads, 0,
                           stream>>>(rec, table, out, n, table_size, k, cuts);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_sweep(const float4* rec, const int* table, const float* cum,
                 SweepScalars sc, float2* out, int n_groups, int offset,
                 int table_size, int k, int spacing, int* cuts,
                 cudaStream_t stream) {
  gather_sweep_kernel<K><<<blocks_for(n_groups, kSweepLanes), kThreads, 0,
                           stream>>>(rec, table, cum, sc, out, n_groups,
                                     offset, table_size, k, spacing, cuts);
  return static_cast<int>(cudaGetLastError());
}

template <typename Launch>
int by_k(int k, Launch launch) {
  switch (k) {
    case 4: return launch(std::integral_constant<int, 4>());
    case 8: return launch(std::integral_constant<int, 8>());
    case 16: return launch(std::integral_constant<int, 16>());
    case 32: return launch(std::integral_constant<int, 32>());
    default: return launch(std::integral_constant<int, 0>());
  }
}

}  // namespace

extern "C" int egg_gather_front(const float* pos, const float* inv_mass,
                                const float* radius, const int* batch,
                                const unsigned char* active,
                                const float* cell_size, float* record,
                                int* bucket, int n, int table_size,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  gather_front_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      reinterpret_cast<const float2*>(pos), inv_mass, radius, batch, active,
      cell_size, reinterpret_cast<float4*>(record), bucket, n, table_size);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int egg_gather_count(const float* record, const int* table,
                                float* out, int n, int table_size, int k,
                                int* cuts, cudaStream_t stream) {
  if (n <= 0) return 0;
  const float4* rec = reinterpret_cast<const float4*>(record);
  return by_k(k, [&](auto kc) {
    return launch_count<decltype(kc)::value>(rec, table, out, n, table_size,
                                             k, cuts, stream);
  });
}

extern "C" int egg_gather_sweep(const float* record, const int* table,
                                const float* cum, const float* max_pairs,
                                const float* collision_c,
                                const float* cohesion_c, const float* overlap,
                                const float* coh_factor,
                                const float* relaxation, float* out,
                                int n_groups, int offset, int table_size,
                                int k, int spacing, int* cuts,
                                cudaStream_t stream) {
  if (n_groups <= 0) return 0;
  const SweepScalars sc{max_pairs, collision_c, cohesion_c, overlap,
                        coh_factor, relaxation};
  const float4* rec = reinterpret_cast<const float4*>(record);
  float2* o = reinterpret_cast<float2*>(out);
  return by_k(k, [&](auto kc) {
    return launch_sweep<decltype(kc)::value>(rec, table, cum, sc, o,
                                             n_groups, offset, table_size, k,
                                             spacing, cuts, stream);
  });
}

// An empty kernel: the fixed cost of one launch, the floor under kernel
// H's time (chip_smoke.py times it from a CUDA graph as H is timed).
extern "C" int egg_empty(cudaStream_t stream) {
  empty_kernel<<<1, 32, 0, stream>>>();
  return static_cast<int>(cudaGetLastError());
}
