// sobol_points: gray-code Sobol points, bit-exact with the direct construction.
//
// Replaces the Pallas kernel repro/kernels/sobol/sobol.py (sobol_points,
// body _kernel): (dim, 32) direction numbers -> (m, dim) points, point i
// being the XOR over the set bits b of gray(skip + i) of v[d, b], computed
// in uint32 arithmetic (the index wraps mod 2^32 as the reference's does).
// Direction numbers and points are held as int64 tensors carrying uint32
// values, the port's representation of unsigned 32-bit data.
//
// Design.  One thread per output element, any m; 32 masked XORs against
// the row of direction numbers, which every thread of a warp shares
// through L1.  Bound: the function's m·dim uint32 outputs, 4 bytes each
// (36 KB at (1000, 9)); the int64 holders make the kernel write twice that.
// Both are far below launch latency; the kernel runs twice per executor build.
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sobol_points_kernel(const long long* __restrict__ sv, long long* __restrict__ out,
                    long long total, int dim, long long skip) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long row = i / dim;
  const int d = static_cast<int>(i - row * dim);
  const unsigned idx = static_cast<unsigned>(skip + row);
  const unsigned gray = idx ^ (idx >> 1);
  const long long* v = sv + d * 32;
  unsigned acc = 0u;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    if ((gray >> b) & 1u) acc ^= static_cast<unsigned>(__ldg(v + b));
  }
  out[i] = static_cast<long long>(acc);
}

}  // namespace

extern "C" int sobol_points_launch(const void* sv, void* out, int m, int dim,
                                   long long skip, int device, void* stream) {
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const long long total = static_cast<long long>(m) * dim;
  const long long blocks = (total + kThreads - 1) / kThreads;
  sobol_points_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sv), static_cast<long long*>(out), total, dim, skip);
  return static_cast<int>(cudaGetLastError());
}
