// sampled_moments: masked five-sum reduction of one z-prefix per feature.
//
// Replaces the Pallas kernel repro/kernels/sampled_agg/sampled_agg.py
// (sampled_moments, body _kernel): (k, cap) f32 values, (k,) i32 plan z and
// a (k,) f32 shift -> (k, 5) f32 [count, Σu, Σu², Σu³, Σu⁴] over columns
// c < z, u = v - shift.  The count is exact; rows with z = 0 come out
// all-zero.  Every sum is a Kahan (hi, lo) pair (compensated.cuh),
// collapsed to hi + lo once, when it is written.
//
// Two paths, chosen by the wrapper (kernels/sampled_agg/sampled_agg.py):
//
// cluster (`cluster_kernel`): a row is cut into `blocks` (1..8) chunks of
// `chunk` columns (a multiple of 32), one block of 256 threads a chunk, and
// the blocks of a row form a thread-block cluster, so that a long prefix is
// read by up to 8 SMs a row (72 blocks at (9, 32768)).  Thread t of a block
// takes the chunk's columns t, t + 256, ... below z, in order, a Kahan step
// a power each: a warp reads 128 contiguous bytes a step, and the compiler
// keeps the loads of several steps in flight.  (A first version gave each
// thread 4-column groups, four 16-byte loads in flight before their Kahan
// steps; on an H100 80GB HBM3 at 700 W it took 0.00287 ms at turbofan's z⁰,
// where the rows kernel took 0.00211-0.00227 in the same run, and this one
// 0.00253-0.00257 against 0.00215-0.00234; at a full (9, 32768) 0.00493
// and 0.00474-0.00476.)  The block folds its threads' pairs by warp
// shuffles (a halving tree) and its warps' pairs the same way in warp 0.  After a cluster barrier the block of rank 0 folds the blocks'
// pairs in rank order through distributed shared memory and writes the
// row; a second barrier keeps the other blocks' shared memory alive until
// it has.  No atomics, flags or global scratch: every launch, eager or
// replayed from a CUDA graph, gives the same bits, those of
// kernels/sampled_agg/emulation.py::clustered_sampled_moments.  A row
// whose prefix lies in block 0's chunk is reduced by block 0 alone, and
// the other blocks return at once: the blocks past z would only add exact
// zero pairs, so the bits are the same (the decision depends on z[f]
// only, and so is the same for every block of the row).
//
// rows (`rows_kernel`, PR 12's design, the earlier one): one block a row
// walks the prefix with strided scalar loads, a Kahan step right after
// each.  It runs only when asked for (blocks = 0), as the earlier design's
// yardstick.
//
// Bound.  The kernel must read the live prefix once: 4·Σ min(z, cap)
// bytes, 4 KB at turbofan's z⁰ (9 rows, z ≈ 1051), 0.35 us at a full
// (9, 32768) on 3.35 TB/s; 8 float operations a value.  At z⁰ the launch
// and one dependent chain of loads, shuffles and shared-memory folds set
// the time; at full prefixes, the blocks' loads and the fold of their pairs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "compensated.cuh"
#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr unsigned kFull = 0xffffffffu;

// The halving tree of shuffles: lane 0 ends with lanes 0..31 folded.
__device__ __forceinline__ void warp_reduce(float& hi, float& lo) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float ohi = __shfl_down_sync(kFull, hi, s);
    const float olo = __shfl_down_sync(kFull, lo, s);
    comp_combine(hi, lo, ohi, olo, hi, lo);
  }
}

__device__ __forceinline__ void kahan_step(float& hi, float& lo, float p) {
  float s, e;
  two_sum(hi, p, s, e);
  hi = s;
  lo = __fadd_rn(lo, e);
}

// Folds the threads' (hi, lo) pairs of each power: a halving tree in each
// warp, then the warps' pairs (zeros past the last warp) in warp 0.  Thread
// 0 ends with the block's four pairs.
__device__ __forceinline__ void block_reduce(float (&hi)[4], float (&lo)[4],
                                             float (*part)[kWarps], int lane, int warp) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    warp_reduce(hi[q], lo[q]);
    if (lane == 0) {
      part[q][warp] = hi[q];
      part[4 + q][warp] = lo[q];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = lane < kWarps ? part[q][lane] : 0.f;
      lo[q] = lane < kWarps ? part[4 + q][lane] : 0.f;
      warp_reduce(hi[q], lo[q]);
    }
  }
}

// --------------------------------------------------------------- cluster
__global__ void __launch_bounds__(kThreads)
cluster_kernel(const float* __restrict__ vals, const int* __restrict__ z,
               const float* __restrict__ shift, float* __restrict__ out, int cap, int chunk) {
  __shared__ float part[8][kWarps];
  __shared__ float pair[8];  // the block's hi[0..3], lo[0..3]
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const int row = blockIdx.x / n_blocks;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int zr = min(max(z[row], 0), cap);
  const bool local = zr <= chunk;  // the whole prefix lies in block 0's chunk
  if (local && b > 0) return;
  const int n = min(max(zr - b * chunk, 0), chunk);  // live columns of this chunk
  const float* v = vals + static_cast<size_t>(row) * cap + static_cast<size_t>(b) * chunk;
  const float sh = shift[row];
  float hi[4] = {0.f, 0.f, 0.f, 0.f};
  float lo[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float p[4];
    powers4(__ldg(v + c), sh, p);
#pragma unroll
    for (int q = 0; q < 4; ++q) kahan_step(hi[q], lo[q], p[q]);
  }
  block_reduce(hi, lo, part, lane, warp);
  if (local) {
    if (threadIdx.x == 0) {
      float* o = out + static_cast<size_t>(row) * 5;
      o[0] = static_cast<float>(zr);
#pragma unroll
      for (int q = 0; q < 4; ++q) o[1 + q] = __fadd_rn(hi[q], lo[q]);
    }
    return;
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      pair[q] = hi[q];
      pair[4 + q] = lo[q];
    }
  }
  cluster.sync();  // every block's pairs are written
  if (b == 0 && threadIdx.x == 0) {
    float* o = out + static_cast<size_t>(row) * 5;
    float other[kMaxCluster][8];
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c) {
      if (c < n_blocks) {
        const float* pc = cluster.map_shared_rank(pair, c);
#pragma unroll
        for (int i = 0; i < 8; ++i) other[c][i] = pc[i];
      }
    }
#pragma unroll
    for (int c = 1; c < kMaxCluster; ++c) {
      if (c < n_blocks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          comp_combine(hi[q], lo[q], other[c][q], other[c][4 + q], hi[q], lo[q]);
        }
      }
    }
    o[0] = static_cast<float>(zr);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[1 + q] = __fadd_rn(hi[q], lo[q]);
  }
  cluster.sync();  // block 0 has read every block's pairs
}

// ------------------------------------------------------------------ rows
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ vals, const int* __restrict__ z,
            const float* __restrict__ shift, float* __restrict__ out, int cap) {
  __shared__ float part[8][kWarps];
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
    for (int q = 0; q < 4; ++q) kahan_step(hi[q], lo[q], p[q]);
  }
  block_reduce(hi, lo, part, lane, warp);
  if (threadIdx.x == 0) {
    float* o = out + static_cast<size_t>(row) * 5;
#pragma unroll
    for (int q = 0; q < 4; ++q) o[1 + q] = __fadd_rn(hi[q], lo[q]);
    o[0] = static_cast<float>(zr);
  }
}

}  // namespace

// blocks = 0: the rows kernel.  blocks = 1..8: the cluster kernel, each
// row cut into chunks of `chunk` columns, which must cover the row:
// blocks·chunk >= cap.
extern "C" int sampled_moments_launch(const void* vals, const void* z, const void* shift,
                                      void* out, int k, int cap, int blocks, int chunk,
                                      int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* zz = static_cast<const int*>(z);
  const auto* sh = static_cast<const float*>(shift);
  auto* o = static_cast<float*>(out);
  if (blocks == 0) {
    rows_kernel<<<k, kThreads, 0, s>>>(v, zz, sh, o, cap);
    return static_cast<int>(cudaGetLastError());
  }
  if (k < 1 || blocks > kMaxCluster || chunk < 1 ||
      static_cast<long long>(blocks) * chunk < cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(k) * blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, cluster_kernel, v, zz, sh, o, cap, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
