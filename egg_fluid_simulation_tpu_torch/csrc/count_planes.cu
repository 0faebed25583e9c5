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
// One thread per slot; bound by the two field reads per partner term
// (occupancy and index), which coalesce across a warp's neighbouring lanes.

#include "pair_terms.cuh"

namespace {

using namespace egg;

__global__ void count_planes_kernel(const float* __restrict__ P,
                                    float* __restrict__ out, int g, int lanes,
                                    int k) {
  const long long idx = blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x;
  if (idx >= static_cast<long long>(g) * lanes) return;
  const long long F = static_cast<long long>(g + 2 * kRowPad) * lanes;
  const int r = static_cast<int>(idx / lanes);
  const int l = static_cast<int>(idx - static_cast<long long>(r) * lanes);
  const long long s = static_cast<long long>(r + kRowPad) * lanes + l;
  if (!(P[kOcc * F + s] > 0.0f)) {
    out[idx] = 0.0f;
    return;
  }
  const float sidx = P[kIdx * F + s];
  const int s_lane = l % k;
  int total = 0;
  for (int dy = -1; dy <= 1; ++dy) {
    const long long orow = static_cast<long long>(r + kRowPad + dy) * lanes;
    for (int d = -(2 * k - 1); d < 2 * k; ++d) {
      if (dy == 0 && d == 0) continue;
      if (!lane_ok(s_lane, d, k, 1)) continue;
      const long long o = orow + wrap(l - d, lanes);
      if (P[kOcc * F + o] > 0.0f && P[kIdx * F + o] > sidx) ++total;
    }
  }
  out[idx] = static_cast<float>(total);
}

}  // namespace

extern "C" int egg_count_planes(const float* planes, float* out, int g,
                                int lanes, int k, cudaStream_t stream) {
  const long long n = static_cast<long long>(g) * lanes;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  count_planes_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      planes, out, g, lanes, k);
  return static_cast<int>(cudaGetLastError());
}
