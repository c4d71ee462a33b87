// ensemble_sum: per-row sum of leaf values over a tensorized tree ensemble.
//
// Replaces the Pallas kernel repro/kernels/tree_qmc/tree_qmc.py
// (ensemble_sum, body _kernel): node tables (T, M) i32 feature / f32
// threshold / i32 left / i32 right / f32 value, x (m, F) f32 -> (m,) f32.
// Traversal is `depth` gather rounds per tree,
//     idx <- x[row, feature[idx]] <= threshold[idx] ? left[idx] : right[idx],
// with leaves looping to themselves.
//
// Design.  One thread per row, any m (the last block masks its tail).  The
// thread walks four trees at a time, interleaving their independent gather
// chains for latency hiding, then adds the four leaves to its sum in tree
// order; the sum is therefore taken in the fixed order t = 0..T-1 with no
// atomics, and two launches give bitwise-equal outputs (the z-plans of the
// serving loop depend on it).  The node tables (about 400 KB for the
// 40 x 511 forest) are read through the read-only L1/L2 path; the upper
// levels of every tree stay hot in L1.
//
// Bound.  The kernel must read x, the tables and write the sums (about
// 0.56 MB at m = 3817 for the forest): ~0.2 us at 3.35 TB/s.  It is in
// fact latency-bound by the chain of T·depth dependent gathers per row,
// with only m / 128 blocks in flight.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kInterleave = 4;

__global__ void __launch_bounds__(kThreads)
ensemble_sum_kernel(const int* __restrict__ feature, const float* __restrict__ threshold,
                    const int* __restrict__ left, const int* __restrict__ right,
                    const float* __restrict__ value, const float* __restrict__ x,
                    float* __restrict__ out, int m, int n_trees, int n_nodes, int n_feat,
                    int depth) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= m) return;
  const float* xr = x + static_cast<size_t>(row) * n_feat;
  float acc = 0.f;
  int t = 0;
  for (; t + kInterleave <= n_trees; t += kInterleave) {
    int idx[kInterleave];
#pragma unroll
    for (int j = 0; j < kInterleave; ++j) idx[j] = 0;
    for (int d = 0; d < depth; ++d) {
#pragma unroll
      for (int j = 0; j < kInterleave; ++j) {
        const int off = (t + j) * n_nodes + idx[j];
        const bool go_left = __ldg(xr + __ldg(feature + off)) <= __ldg(threshold + off);
        idx[j] = go_left ? __ldg(left + off) : __ldg(right + off);
      }
    }
#pragma unroll
    for (int j = 0; j < kInterleave; ++j) {
      acc = __fadd_rn(acc, __ldg(value + (t + j) * n_nodes + idx[j]));
    }
  }
  for (; t < n_trees; ++t) {
    int idx = 0;
    for (int d = 0; d < depth; ++d) {
      const int off = t * n_nodes + idx;
      const bool go_left = __ldg(xr + __ldg(feature + off)) <= __ldg(threshold + off);
      idx = go_left ? __ldg(left + off) : __ldg(right + off);
    }
    acc = __fadd_rn(acc, __ldg(value + t * n_nodes + idx));
  }
  out[row] = acc;
}

}  // namespace

extern "C" int ensemble_sum_launch(const void* feature, const void* threshold,
                                   const void* left, const void* right, const void* value,
                                   const void* x, void* out, int m, int n_trees,
                                   int n_nodes, int n_feat, int depth, int device,
                                   void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const int blocks = (m + kThreads - 1) / kThreads;
  ensemble_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(feature), static_cast<const float*>(threshold),
      static_cast<const int*>(left), static_cast<const int*>(right),
      static_cast<const float*>(value), static_cast<const float*>(x),
      static_cast<float*>(out), m, n_trees, n_nodes, n_feat, depth);
  return static_cast<int>(cudaGetLastError());
}
