// masked_select_ranks: order statistics of each z-prefix at given ranks.
//
// Replaces the Pallas kernel repro/kernels/sampled_agg/quantile_select.py
// (masked_select_ranks, body _kernel): (h, cap) f32 values, (h,) i32 plan
// z and (h, R) i32 target ranks -> (h, R) f32, out[f, r] being the
// targets[f, r]-th smallest value of row f's prefix v[f, 0..z-1] with ties
// ordered by column index, and +inf where the target (clipped to
// [0, cap-1]) is at or past z, which includes every target of a z = 0 row.
// The outputs are selected values, not arithmetic, so the kernel is bitwise
// equal to its plain version (a stable sort of the prefix, +inf past z).
//
// Design.  The TPU kernel walks (k tiles, candidate tiles, comparand
// tiles) in order and carries each candidate's rank in VMEM across the
// comparand axis; here the comparand walk is a loop inside the block.
// Phase 1, one block per (feature row, tile of 256 candidate columns):
// each thread takes one candidate i < z and counts
//   rank(i) = #{j < z : v_j < v_i  or  (v_j == v_i and j < i)}
// while the prefix streams through shared memory in tiles of 256.  The
// ranks of the prefix are a permutation of 0..z-1, so writing v_i to
// scratch[f, rank(i)] is a stable counting sort of the live prefix.  Only
// the prefix is compared: a column past z is +inf with a larger index than
// any prefix column, so it never ranks below a prefix value.  z stays on
// the device: blocks whose tile starts at or past z[f] return at once, and
// the grid is sized by cap.  Phase 2, one thread per (row, target): read
// scratch[f, t] for t < z, else +inf.
//
// Bound.  The function must read the live prefix, the targets and z and
// write the outputs once: at h = 3, R = 257 and z = 1000 a row, 24 KB, a
// few nanoseconds at 3.35 TB/s.  The kernel does h·z² compares instead
// (3e6 at z = 1000, but 3.2e9 at a full 32768-row prefix), so its time
// grows as z²: that compare count, not the bytes, is what a faster
// selection (a radix or bitonic sort of the prefix) would attack.
#include <cuda_runtime.h>

#include <math_constants.h>

#include "device_guard.cuh"

namespace {

constexpr int kTile = 256;

__global__ void __launch_bounds__(kTile)
rank_scatter_kernel(const float* __restrict__ vals, const int* __restrict__ z,
                    float* __restrict__ scratch, int cap) {
  __shared__ float tile[kTile];
  const int f = blockIdx.y;
  const int zf = min(max(z[f], 0), cap);
  const int t0 = blockIdx.x * kTile;
  if (t0 >= zf) return;  // the whole block is past the prefix
  const float* v = vals + static_cast<size_t>(f) * cap;
  const int i = t0 + threadIdx.x;
  const bool live = i < zf;
  const float vi = live ? v[i] : 0.f;
  int rank = 0;
  for (int j0 = 0; j0 < zf; j0 += kTile) {
    const int j = j0 + threadIdx.x;
    if (j < zf) tile[threadIdx.x] = v[j];
    __syncthreads();
    const int len = min(kTile, zf - j0);
    if (live) {
      for (int c = 0; c < len; ++c) {
        const float vj = tile[c];
        rank += (vj < vi) | ((vj == vi) & (j0 + c < i));
      }
    }
    __syncthreads();
  }
  if (live) scratch[static_cast<size_t>(f) * cap + rank] = vi;
}

__global__ void __launch_bounds__(kTile)
gather_kernel(const float* __restrict__ scratch, const int* __restrict__ z,
              const int* __restrict__ targets, float* __restrict__ out, int h,
              int cap, int r) {
  const long long idx = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
  if (idx >= static_cast<long long>(h) * r) return;
  const int f = static_cast<int>(idx / r);
  const int zf = min(max(z[f], 0), cap);
  const int t = min(max(targets[idx], 0), cap - 1);
  out[idx] = t < zf ? scratch[static_cast<size_t>(f) * cap + t] : CUDART_INF_F;
}

}  // namespace

extern "C" int masked_select_ranks_launch(const void* vals, const void* z,
                                          const void* targets, void* scratch,
                                          void* out, int h, int cap, int r,
                                          int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((cap + kTile - 1) / kTile, h);
  rank_scatter_kernel<<<grid, kTile, 0, s>>>(static_cast<const float*>(vals),
                                             static_cast<const int*>(z),
                                             static_cast<float*>(scratch), cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(h) * r;
  gather_kernel<<<static_cast<unsigned>((total + kTile - 1) / kTile), kTile, 0, s>>>(
      static_cast<const float*>(scratch), static_cast<const int*>(z),
      static_cast<const int*>(targets), static_cast<float*>(out), h, cap, r);
  return static_cast<int>(cudaGetLastError());
}
