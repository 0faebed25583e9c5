// Kernel H: the gather engine's collision pass, one Jacobi pair pass of a
// population on its hash grid (gather_sweep) and the ordered budget's
// per-particle pair count (gather_count).
//
// Replaces: no TPU kernel. In the JAX package XLA fuses solve_pairs
//           (egg_fluid_simulation_tpu/ops/solver.py) by itself; H replaces
//           the port's plain PyTorch form of it (ops/kernels/gather_kernel.py:
//           gather_sweep_plain, gather_count_plain; formerly
//           ops/solver.py solve_pairs / _ordered_budget), a few hundred
//           small ops on (N, 9K) candidate arrays a pass.
//
// What it computes, per particle p (N particles, a table of table_size
// buckets of K slots, -1 = empty slot; the grid of ops/grid.build_grid):
// - the nine buckets of p's 3x3 cells, bucket = ((cx * 0x9E3779B1) ^
//   (cy * 0x85EBCA77)) mod table_size in uint32 arithmetic (bit-identical
//   to grid._bucket_of's masked products), a bucket repeated within the nine
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
//   candidates; out[p] = pos[p] + (active[p] ? relaxation * total : 0).
//   The per-pair arithmetic is the plain version's op for op (the library
//   builds with --fmad=false, IEEE '/' and sqrtf), so a pair's term rounds
//   alike; the sum runs in another order (a lane's candidates, then a
//   shuffle tree), so totals agree to rounding.
//
// Design: a 16-lane group owns a particle (16 particles a 256-thread
// block, 512 blocks at N = 8192 on 132 SMs). Lane s takes slot s (then
// s + 16, ...) of each of the nine table rows, so a group reads a row of
// K = 16 slots as one coalesced 64-byte load. Each particle writes its
// own output: a Jacobi pass sums only its own side of each pair, so
// nothing is atomic, and the group's partial sums meet in a fixed
// shuffle tree (deterministic run to run). Nothing of size N x 9K is
// ever written: the candidate array and the gathered (C, 9K, 6) block of
// the plain version exist only as loads.
// Bound on the H100: latency. Each candidate is a chain of three
// dependent loads (the table slot, the candidate's cell, its fields), all
// from L2 at the gather engine's sizes (N <= 16384: the fields take
// 32 B a particle, the table 1 MB at 16384 x 16 slots); the bytes a pass
// must move and its arithmetic take a few microseconds at most
// (chip_smoke.py check.gather_pairs prints both bounds). What hides the
// latency is the number of groups in flight: up to 8 blocks, 128
// particles, an SM. A lane walks the nine rows one after another; the
// nine buckets are recomputed from their index (a few integer multiplies)
// rather than kept in an indexed array, which spilled to local memory.
//
// Built without --use_fast_math (IEEE division and sqrt), as the rest of
// the library.

#include <cuda_runtime.h>

namespace {

constexpr int kGroup = 16;       // lanes a particle
constexpr int kThreads = 256;    // 16 particles a block
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

// A bit per bucket of the nine that repeats an earlier one. The nine are
// held in registers here (a fully unrolled loop); the candidate walk
// recomputes each from its index instead of indexing an array, which would
// go to local memory.
__device__ __forceinline__ unsigned repeated_buckets(int cx, int cy,
                                                     unsigned mask) {
  int bucket[9];
  unsigned repeated = 0u;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    bucket[b] = nth_bucket(cx, cy, b, mask);
#pragma unroll
    for (int e = 0; e < b; ++e) {
      if (bucket[e] == bucket[b]) repeated |= 1u << b;
    }
  }
  return repeated;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, kGroup);
  return v;
}

__device__ __forceinline__ int group_sum(int v) {
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off, kGroup);
  return v;
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

__global__ void __launch_bounds__(kThreads)
gather_count_kernel(const int* __restrict__ table,
                    const int* __restrict__ cell_xy,
                    const unsigned char* __restrict__ active,
                    float* __restrict__ out, int n, int table_size, int k) {
  const int p = blockIdx.x * (kThreads / kGroup) + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  int count = 0;
  if (p < n && active[p]) {
    const int cx = cell_xy[2 * p], cy = cell_xy[2 * p + 1];
    const unsigned mask = static_cast<unsigned>(table_size - 1);
    const unsigned repeated = repeated_buckets(cx, cy, mask);
#pragma unroll 1
    for (int b = 0; b < 9; ++b) {
      if (repeated & (1u << b)) continue;
      const int* row =
          table + static_cast<long long>(nth_bucket(cx, cy, b, mask)) * k;
      for (int s = lane; s < k; s += kGroup) {
        const int c = row[s];
        if (c <= p) continue;          // empty (-1), itself or earlier
        if (adjacent(cell_xy[2 * c], cx) && adjacent(cell_xy[2 * c + 1], cy))
          ++count;
      }
    }
  }
  count = group_sum(count);
  if (lane == 0 && p < n) out[p] = static_cast<float>(count);
}

struct SweepScalars {
  const float* max_pairs;   // null: budget off
  const float* collision_c;
  const float* cohesion_c;
  const float* overlap;
  const float* coh_factor;
  const float* relaxation;
};

__global__ void __launch_bounds__(kThreads)
gather_sweep_kernel(const float* __restrict__ pos,
                    const float* __restrict__ inv_mass,
                    const float* __restrict__ radius,
                    const int* __restrict__ batch,
                    const unsigned char* __restrict__ active,
                    const int* __restrict__ cell_xy,
                    const int* __restrict__ table,
                    const float* __restrict__ cum, SweepScalars sc,
                    float* __restrict__ out, int n, int table_size, int k,
                    int spacing) {
  const int p = blockIdx.x * (kThreads / kGroup) + threadIdx.x / kGroup;
  const int lane = threadIdx.x % kGroup;
  const bool live = p < n && active[p];
  float tx = 0.0f, ty = 0.0f;
  if (live) {
    const float sx = pos[2 * p], sy = pos[2 * p + 1];
    const float sw = inv_mass[p], sr = radius[p];
    const int sb = batch[p];
    const bool ordered = sc.max_pairs != nullptr;
    const float max_pairs = ordered ? *sc.max_pairs : 0.0f;
    const float s_cum = ordered ? cum[p] : 0.0f;
    const float collision_c = *sc.collision_c, cohesion_c = *sc.cohesion_c;
    const float overlap = *sc.overlap, coh_factor = *sc.coh_factor;
    const int cx = cell_xy[2 * p], cy = cell_xy[2 * p + 1];
    const unsigned mask = static_cast<unsigned>(table_size - 1);
    const unsigned repeated = repeated_buckets(cx, cy, mask);
#pragma unroll 1
    for (int b = 0; b < 9; ++b) {
      if (repeated & (1u << b)) continue;
      const int* row =
          table + static_cast<long long>(nth_bucket(cx, cy, b, mask)) * k;
      for (int s = lane; s < k; s += kGroup) {
        const int c = row[s];
        if (c < 0 || c == p) continue;
        if (!(adjacent(cell_xy[2 * c], cx) && adjacent(cell_xy[2 * c + 1], cy)))
          continue;
        if (ordered) {
          const float cum_min = c < p ? cum[c] : s_cum;
          if (!(cum_min < max_pairs)) continue;
        }
        const float w_sum = sw + inv_mass[c];
        if (!(w_sum >= kEps)) continue;                       // :1601
        const float dx = pos[2 * c] - sx;
        const float dy = pos[2 * c + 1] - sy;
        const float dist2 = dx * dx + dy * dy;
        const float dist = sqrtf(dist2);
        const float inv_dist = dist > kEps ? 1.0f / fmaxf(dist, kEps) : 0.0f;
        const float r_sum = sr + radius[c];
        const float min_dist = overlap * r_sum;               // :1632-1654
        float scale = dist2 <= min_dist * min_dist
                          ? half_scale(dist, min_dist, w_sum, collision_c, sw)
                          : 0.0f;
        if (spacing) {                                        // :1603-1630
          const float coh_dist = coh_factor * r_sum;
          const float coh =
              batch[c] == sb && dist2 <= coh_dist * coh_dist
                  ? half_scale(dist, coh_dist, w_sum, cohesion_c, sw)
                  : 0.0f;
          scale = coh + scale;
        }
        tx += -(dx * inv_dist) * scale;
        ty += -(dy * inv_dist) * scale;
      }
    }
  }
  tx = group_sum(tx);
  ty = group_sum(ty);
  if (lane == 0 && p < n) {
    const float relax = *sc.relaxation;
    out[2 * p] = pos[2 * p] + (live ? relax * tx : 0.0f);
    out[2 * p + 1] = pos[2 * p + 1] + (live ? relax * ty : 0.0f);
  }
}

unsigned blocks_for(int n) {
  constexpr int per_block = kThreads / kGroup;
  return static_cast<unsigned>((n + per_block - 1) / per_block);
}

}  // namespace

extern "C" int egg_gather_count(const int* table, const int* cell_xy,
                                const unsigned char* active, float* out,
                                int n, int table_size, int k,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  gather_count_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      table, cell_xy, active, out, n, table_size, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int egg_gather_sweep(const float* pos, const float* inv_mass,
                                const float* radius, const int* batch,
                                const unsigned char* active,
                                const int* cell_xy, const int* table,
                                const float* cum, const float* max_pairs,
                                const float* collision_c,
                                const float* cohesion_c, const float* overlap,
                                const float* coh_factor,
                                const float* relaxation, float* out, int n,
                                int table_size, int k, int spacing,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  const SweepScalars sc{max_pairs, collision_c, cohesion_c, overlap,
                        coh_factor, relaxation};
  gather_sweep_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      pos, inv_mass, radius, batch, active, cell_xy, table, cum, sc, out, n,
      table_size, k, spacing);
  return static_cast<int>(cudaGetLastError());
}
