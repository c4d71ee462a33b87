// prefix_power_sums: inclusive prefix sums of (v - shift)^p, p = 1..4.
//
// Replaces the Pallas kernel repro/kernels/sampled_agg/prefix_stats.py
// (prefix_power_sums, body _prefix_kernel): (k, cap) f32 values and a (k,)
// shift -> (k, cap, 4) f32 tables, compensated so that a 60k-row
// heavy-tailed column keeps double-precision-class accuracy.
//
// Design.  One block per feature row walks the row in tiles of 1024
// columns, one column per thread.  Inside a tile each of the four powers
// is scanned as an unevaluated (hi, lo) pair with the two-sum combine: a
// Hillis-Steele warp scan over shuffles, then a scan of the 32 warp totals
// by warp 0 through shared memory.  The running total of the earlier tiles
// is a (hi, lo) pair kept identically in every thread and combined in
// front of each element before the pair collapses to hi + lo.  Each thread
// writes its column's four sums as one 16-byte store.
//
// Bound.  At k = 9, cap = 32768 the kernel must read 1.2 MB and write
// 4.7 MB: about 1.8 us at 3.35 TB/s, so bytes bound it.  With one block
// per row only k blocks run (9 of 132 SMs), and the tiles of a row are
// walked one after another; that low occupancy, not the bytes, sets its
// time.  A reduce-then-scan over column chunks would fill the card.
#include <cuda_runtime.h>

#include "compensated.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void warp_scan(float& hi, float& lo, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float ohi = __shfl_up_sync(kFull, hi, s);
    const float olo = __shfl_up_sync(kFull, lo, s);
    if (lane >= s) comp_combine(ohi, olo, hi, lo, hi, lo);
  }
}

__global__ void __launch_bounds__(kThreads)
prefix_power_sums_kernel(const float* __restrict__ vals,
                         const float* __restrict__ shift,
                         float4* __restrict__ out, int cap) {
  __shared__ float tot_hi[4][kWarps];
  __shared__ float tot_lo[4][kWarps];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* v = vals + static_cast<size_t>(row) * cap;
  float4* o = out + static_cast<size_t>(row) * cap;
  const float sh = shift[row];
  float carry_hi[4] = {0.f, 0.f, 0.f, 0.f};
  float carry_lo[4] = {0.f, 0.f, 0.f, 0.f};

  for (int base = 0; base < cap; base += kThreads) {
    const int c = base + threadIdx.x;
    float hi[4], lo[4];
    // columns past cap contribute exact zeros to the tile total
    powers4(c < cap ? v[c] : sh, sh, hi);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = 0.f;
      warp_scan(hi[q], lo[q], lane);
      if (lane == 31) {
        tot_hi[q][warp] = hi[q];
        tot_lo[q][warp] = lo[q];
      }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float th = tot_hi[q][lane], tl = tot_lo[q][lane];
        warp_scan(th, tl, lane);
        tot_hi[q][lane] = th;
        tot_lo[q][lane] = tl;
      }
    }
    __syncthreads();
    float res[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (warp > 0) {
        comp_combine(tot_hi[q][warp - 1], tot_lo[q][warp - 1], hi[q], lo[q], hi[q], lo[q]);
      }
      comp_combine(carry_hi[q], carry_lo[q], hi[q], lo[q], hi[q], lo[q]);
      res[q] = __fadd_rn(hi[q], lo[q]);
      comp_combine(carry_hi[q], carry_lo[q], tot_hi[q][kWarps - 1],
                   tot_lo[q][kWarps - 1], carry_hi[q], carry_lo[q]);
    }
    if (c < cap) o[c] = make_float4(res[0], res[1], res[2], res[3]);
    __syncthreads();  // the totals are rewritten by the next tile
  }
}

}  // namespace

extern "C" int prefix_power_sums_launch(const void* vals, const void* shift, void* out,
                                        int k, int cap, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  prefix_power_sums_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const float*>(shift),
      static_cast<float4*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
