// Kernel A: place cell-sorted particle payloads into the dense field planes.
//
// Replaces: egg_fluid_simulation_tpu/ops/pallas/place_kernel.py
//           (_place_pallas / _make_kernel / _place_chunk), the TPU's
//           one-hot-matmul stand-in for the scatter in ops/dense.py
//           (bin_to_planes, the golden model).
//
// What it computes: for every sorted entry j whose slot s = slot_sorted[j]
// is a real slot (s < G*L), planes[f, ROW_PAD + s / L, s % L] =
// pack_sorted[j, f] for all fields f. Slots are unique by construction (the
// cell rank makes them so), so no two threads write one element. The torus
// halo rows are written in the same pass: an entry in the last ROW_PAD rows
// is copied into the top halo, one in the first ROW_PAD rows into the
// bottom halo (ops/dense.fill_halo). The caller zero-fills the output.
//
// Bound on the H100: memory. Every entry is read once and written once (or
// twice for halo rows); there is no arithmetic. The design therefore moves
// each value exactly once with one thread per entry: neighbouring sorted
// entries land in neighbouring lanes, so the stores of a warp coalesce,
// and there is no one-hot product, byte-plane split or window search at all.
//
// Bit-exact by construction (pure copies). Built without --use_fast_math;
// nothing here would change under it, but the library's other kernels need
// IEEE expf, rsqrtf and division, and all of them share one build.

#include <cuda_runtime.h>

namespace {

__global__ void place_planes_kernel(const int* __restrict__ slot_sorted,
                                    const float* __restrict__ pack_sorted,
                                    float* __restrict__ out, int n,
                                    int n_fields, int g, int lanes,
                                    int row_pad) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (j >= n) return;
  const long long slot = slot_sorted[j];
  const long long total = static_cast<long long>(g) * lanes;
  if (slot < 0 || slot >= total) return;  // over-budget entry: not placed
  const int r = static_cast<int>(slot / lanes);
  const int l = static_cast<int>(slot - static_cast<long long>(r) * lanes);
  const long long plane = static_cast<long long>(g + 2 * row_pad) * lanes;
  // torus halo copy of this entry, or -1 (g >= 2 * row_pad, so at most one)
  int halo = -1;
  if (r >= g - row_pad) {
    halo = r - (g - row_pad);  // top halo mirrors the last real rows
  } else if (r < row_pad) {
    halo = row_pad + g + r;    // bottom halo mirrors the first real rows
  }
  const float* src = pack_sorted + j * n_fields;
  const long long at = static_cast<long long>(row_pad + r) * lanes + l;
  const long long at_halo = static_cast<long long>(halo) * lanes + l;
  for (int f = 0; f < n_fields; ++f) {
    const float v = src[f];
    float* base = out + f * plane;
    base[at] = v;
    if (halo >= 0) base[at_halo] = v;
  }
}

}  // namespace

extern "C" int egg_place_planes(const int* slot_sorted,
                                const float* pack_sorted, float* out, int n,
                                int n_fields, int g, int lanes, int row_pad,
                                cudaStream_t stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    place_planes_kernel<<<blocks, threads, 0, stream>>>(
        slot_sorted, pack_sorted, out, n, n_fields, g, lanes, row_pad);
  }
  return static_cast<int>(cudaGetLastError());
}
