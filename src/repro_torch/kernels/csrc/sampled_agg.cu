// sampled_moments: masked five-sum reduction of one z-prefix per feature.
//
// Replaces the Pallas kernel repro/kernels/sampled_agg/sampled_agg.py
// (sampled_moments, body _kernel): (k, cap) f32 values, (k,) i32 plan z and
// a (k,) f32 shift -> (k, 5) f32 [count, Σu, Σu², Σu³, Σu⁴] over columns
// c < z, u = v - shift.  The count is exact; rows with z = 0 come out
// all-zero.
//
// Design.  One block per feature row.  Each thread walks its strided
// columns of the live prefix only (columns >= z are never read) and keeps
// a Kahan (hi, lo) pair per power; the block then combines the pairs with
// the two-sum combine, by warp shuffles and one pass through shared
// memory, and collapses hi + lo once at the end.
//
// Bound.  The kernel must read the live prefix once: 4·Σ min(z, cap) bytes
// (at most 9·1024·4 = 37 KB where "auto" takes the rescan, caps <= 1024;
// up to 1.2 MB under "ref" at cap 32768), so under "auto" a call is a few
// microseconds of launch and reduction latency, not bandwidth.  Nine
// blocks leave most SMs idle; a long prefix under "ref" would want several
// blocks per row and a second combining pass.
#include <cuda_runtime.h>

#include "compensated.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void warp_reduce(float& hi, float& lo) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ohi = __shfl_down_sync(kFull, hi, s);
    const float olo = __shfl_down_sync(kFull, lo, s);
    comp_combine(hi, lo, ohi, olo, hi, lo);
  }
}

__global__ void __launch_bounds__(kThreads)
sampled_moments_kernel(const float* __restrict__ vals, const int* __restrict__ z,
                       const float* __restrict__ shift, float* __restrict__ out,
                       int cap) {
  __shared__ float part_hi[4][kWarps];
  __shared__ float part_lo[4][kWarps];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int zr = min(max(z[row], 0), cap);
  const float* v = vals + static_cast<size_t>(row) * cap;
  const float sh = shift[row];
  float hi[4] = {0.f, 0.f, 0.f, 0.f};
  float lo[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = threadIdx.x; c < zr; c += kThreads) {
    float p[4];
    powers4(v[c], sh, p);
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // kahan_step: (hi, lo) += p
      float s, e;
      two_sum(hi[q], p[q], s, e);
      hi[q] = s;
      lo[q] = __fadd_rn(lo[q], e);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    warp_reduce(hi[q], lo[q]);
    if (lane == 0) {
      part_hi[q][warp] = hi[q];
      part_lo[q][warp] = lo[q];
    }
  }
  __syncthreads();
  if (warp == 0) {
    float* o = out + static_cast<size_t>(row) * 5;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float h = lane < kWarps ? part_hi[q][lane] : 0.f;
      float l = lane < kWarps ? part_lo[q][lane] : 0.f;
      warp_reduce(h, l);
      if (lane == 0) o[1 + q] = __fadd_rn(h, l);
    }
    if (lane == 0) o[0] = static_cast<float>(zr);
  }
}

}  // namespace

extern "C" int sampled_moments_launch(const void* vals, const void* z, const void* shift,
                                      void* out, int k, int cap, int device,
                                      void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  sampled_moments_kernel<<<k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(z),
      static_cast<const float*>(shift), static_cast<float*>(out), cap);
  return static_cast<int>(cudaGetLastError());
}
