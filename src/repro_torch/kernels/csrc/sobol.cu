// sobol_points: gray-code Sobol points, bit-exact with the direct construction.
//
// Replaces the Pallas kernel repro/kernels/sobol/sobol.py (sobol_points,
// body _kernel): (dim, 32) direction numbers -> (m, dim) points, point i
// being the XOR over the set bits b of gray(skip + i) of v[d, b], computed
// in uint32 arithmetic (the index wraps mod 2^32 as the reference's does).
//
// Bound: the function's m·dim uint32 outputs, 4 bytes each, and the (dim,
// 32) direction numbers read once (36 KB at (1000, 9), 16 MB at (65536,
// 64)); at the served grids far below launch latency.  The executor builds
// its whole QMC grid, (max(m, m_sobol), 2k), with one launch.
//
// Two paths.
//
// runs (sobol_points_launch): a block covers a tile of `runs · run`
// consecutive rows and every dimension; thread t < runs·dim makes one
// dimension d = t % dim (32-bit division by a small int) of one run of
// `run` consecutive points.  The run's first point comes from the direct
// construction, every later one from the gray-code recurrence
// x(i) = x(i-1) ^ v[ctz(i)] (ctz(0) read as 31: gray(2^32 - 1) = 2^31, so
// the wrap to index 0 clears bit 31), one XOR a point instead of up to 32.
// The direction numbers are staged as uint32 in shared memory (rows padded
// to 33 words, so the threads of a warp, one dimension each, read distinct
// banks); the tile is assembled in shared memory and written out as one
// contiguous run of rows·dim values, coalesced.  The same pass writes the
// points' uint32 bits and/or the QMC uniforms (x + 0.5)·2^-32, rounded as
// the reference's qmc_uniforms rounds them: float(x) to nearest, times
// 2^-32 (exact), plus 2^-33 to nearest (either pointer may be null).
//
// direct (sobol_points_direct_launch): the earlier design (one thread per
// element, 32 masked XORs, a 64-bit division, int64 holders), kept as the
// yardstick the runs path is timed against.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBits = 32;
constexpr int kMaxDim = 64;
constexpr int kMaxRun = 32;
constexpr int kStride = kBits + 1;  // padded row of direction numbers

__global__ void __launch_bounds__(kThreads)
sobol_runs_kernel(const unsigned* __restrict__ sv, unsigned* __restrict__ bits,
                  float* __restrict__ unif, int m, int dim, unsigned skip, int run,
                  int runs) {
  __shared__ unsigned v[kMaxDim * kStride];
  extern __shared__ unsigned tile[];  // runs·run rows of dim values
  for (int i = threadIdx.x; i < dim * kBits; i += kThreads) {
    v[(i / kBits) * kStride + i % kBits] = sv[i];
  }
  __syncthreads();
  const int row0 = blockIdx.x * runs * run;
  const int rows = min(runs * run, m - row0);
  const int t = threadIdx.x;
  if (t < runs * dim) {
    const int d = t % dim;
    const int first = (t / dim) * run;
    if (first < rows) {
      const unsigned* vd = v + d * kStride;
      unsigned idx = skip + static_cast<unsigned>(row0 + first);
      const unsigned gray = idx ^ (idx >> 1);
      unsigned x = 0u;
#pragma unroll
      for (int b = 0; b < kBits; ++b) {
        if ((gray >> b) & 1u) x ^= vd[b];
      }
      tile[first * dim + d] = x;
      const int last = min(run, rows - first);
      for (int i = 1; i < last; ++i) {
        ++idx;
        x ^= vd[(__ffs(static_cast<int>(idx)) + 31) & 31];
        tile[(first + i) * dim + d] = x;
      }
    }
  }
  __syncthreads();
  const long long base = static_cast<long long>(row0) * dim;
  for (int i = threadIdx.x; i < rows * dim; i += kThreads) {
    const unsigned x = tile[i];
    if (bits != nullptr) bits[base + i] = x;
    if (unif != nullptr) {
      unif[base + i] = __fadd_rn(__fmul_rn(__uint2float_rn(x), 0x1p-32f), 0x1p-33f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sobol_direct_kernel(const long long* __restrict__ sv, long long* __restrict__ out,
                    long long total, int dim, long long skip) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / dim;
  const int d = static_cast<int>(i - row * dim);
  const unsigned idx = static_cast<unsigned>(skip + row);
  const unsigned gray = idx ^ (idx >> 1);
  const long long* v = sv + d * kBits;
  unsigned acc = 0u;
#pragma unroll
  for (int b = 0; b < kBits; ++b) {
    if ((gray >> b) & 1u) acc ^= static_cast<unsigned>(__ldg(v + b));
  }
  out[i] = static_cast<long long>(acc);
}

}  // namespace

// runs path: `run` points a thread (1..32), `runs` = 256 / dim runs a block.
extern "C" int sobol_points_launch(const void* sv, void* bits, void* unif, int m, int dim,
                                   unsigned skip, int run, int device, void* stream) {
  if (dim < 1 || dim > kMaxDim || run < 1 || run > kMaxRun || m < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const int runs = kThreads / dim;
  const int tile_rows = runs * run;
  const int blocks = (m + tile_rows - 1) / tile_rows;
  const size_t smem = static_cast<size_t>(tile_rows) * dim * sizeof(unsigned);
  sobol_runs_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned*>(sv), static_cast<unsigned*>(bits),
      static_cast<float*>(unif), m, dim, skip, run, runs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sobol_points_direct_launch(const void* sv, void* out, int m, int dim,
                                          long long skip, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const long long total = static_cast<long long>(m) * dim;
  const long long blocks = (total + kThreads - 1) / kThreads;
  sobol_direct_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sv), static_cast<long long*>(out), total, dim, skip);
  return static_cast<int>(cudaGetLastError());
}
