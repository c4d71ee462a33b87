// masked_select_ranks: order statistics of each z-prefix at given ranks.
//
// Replaces the Pallas kernel repro/kernels/sampled_agg/quantile_select.py
// (masked_select_ranks, body _kernel): (h, cap) f32 values, (h,) i32 plan
// z and (h, R) i32 target ranks -> (h, R) f32, out[f, r] being the
// targets[f, r]-th smallest value of row f's prefix v[f, 0..z-1] with ties
// ordered by column index, and +inf where the target (clipped to
// [0, cap-1]) is at or past z, which includes every target of a z = 0 row.
// The outputs are selected values, not arithmetic, so the kernel is bitwise
// equal to its plain version (a stable sort of the row with +inf past z).
//
// Two paths, chosen by the wrapper (kernels/sampled_agg/quantile_select.py):
//
// radix (`radix_kernel<kItems>`): a stable LSD radix sort of the live
// prefix, 4 passes of 8 bits, then the gather, in one launch.  A row is cut
// into chunks of 1024·kItems columns (kItems = 1, 2, 4 or 8), one block of
// 1024 threads a chunk, and the chunks of a row form a thread-block cluster
// of up to 8 blocks (cap <= 65536), so the rows run side by side and a long
// row spreads over 8 SMs.  Each element is a (key, bits) pair: the key maps
// the float's order to unsigned order, -0.0 to +0.0 (so that equal values
// keep column order, as the stable sort keeps them) and every NaN to one
// key above +inf (where torch.sort puts NaN); the bits are the original
// value, which is what is written out.  A pass, for each element:
//   1. a thread holds kItems elements in registers, slot j of lane l of
//      warp w being chunk position w·32·kItems + j·32 + l, so that slots
//      taken in order, lanes in order within a slot, are column order;
//      a warp ranks each slot's digits by __match_any_sync against its
//      running digit counts in shared memory, so its rank among equal
//      digits follows that order (no shared-memory atomics, whose order
//      would change from launch to launch);
//   2. the warps' counts become, per digit, an exclusive prefix over the
//      warps and the block's count, which each block of the cluster
//      publishes; after a cluster barrier every block reads the cluster's
//      counts through distributed shared memory and takes its base per
//      digit: all smaller digits of the row, plus this digit in earlier
//      blocks;
//   3. each element goes to base + warp prefix + warp rank, written to the
//      shared memory of the block that holds that position (distributed
//      shared memory); a second barrier, and each block reloads its chunk.
// After the last pass the row lies sorted across the cluster's shared
// memory, and each block gathers its share of the R targets from it.  z
// stays on the device: the launch plan comes from (h, cap) only, and blocks
// whose chunk lies past z[f] still take part in every barrier.  A row whose
// prefix fits block 0's chunk (every z <= 1024·kItems) is sorted and
// gathered by block 0 alone with block barriers; the other blocks of its
// cluster return at once (a decision that is the same for every block of
// the row, as it depends on z[f] only, and no block of such a row touches
// another's shared memory).  A prefix of at most kCountMax values skips the
// passes: each of its elements counts the keys that precede it (z² compares
// in block 0, cheaper than four passes below z ≈ 360), which gives the same
// stable order.
//
// rank (`rank_scatter_kernel`, then `gather_kernel`; PR 13's design, the
// earlier one): each candidate counts the prefix values that precede it,
// rank(i) = #{j < z : v_j < v_i or (v_j == v_i and j < i)}, and is written
// to scratch[f, rank(i)]; a second launch gathers.  h·z² compares.  It runs
// for caps past the radix path's 65536 columns, or when asked for, as the
// earlier design's yardstick.
//
// Bound.  The function must read the live prefix, z and the targets once
// and write the outputs: 4·(Σz + h + 2·h·R) bytes, 0.0046 us at z = 760,
// h = 3, R = 257 on 3.35 TB/s, and 0.24 us at three full 65536-column rows.
// Bytes are not what limits the kernel, latency is: a radix pass is a
// chain of warp matches, five block or cluster barriers and a scatter
// through (distributed) shared memory, so the radix path takes about 8-9 us
// at z = 760 and 41 us at a full 65536-column row on an H100 80GB HBM3 at
// 700 W (PERF.md §6).  Four passes are the floor of the design; counting
// replaces them for short prefixes.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include <math_constants.h>

#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;

// ------------------------------------------------------------------- radix
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 256;
constexpr int kPasses = 4;
constexpr int kMaxCluster = 8;
constexpr unsigned kNanKey = 0xffffffffu;
// Prefixes of at most this many values are ranked by counting (z² compares
// in one block), longer ones by the radix passes, whose chain costs about
// the same at every z: on an H100 the two cross near z = 360 (PERF.md §6;
// kernel_ab.py against a copy of this file with kCountMax = 0).
constexpr int kCountMax = 352;

// Unsigned key whose order is the float order of torch.sort: -0.0 as +0.0
// and every NaN above +inf (0x7f800000 maps to 0xff800000).
__device__ __forceinline__ unsigned sort_key(unsigned bits) {
  const unsigned mag = bits & 0x7fffffffu;
  if (mag > 0x7f800000u) return kNanKey;
  if (mag == 0u) bits = 0u;
  return (bits & 0x80000000u) ? ~bits : bits | 0x80000000u;
}

template <int kItems>
constexpr size_t radix_smem_bytes() {
  // the chunk's (key, bits) pairs, the warps' digit counts, the block's
  // counts (published to the cluster), the digit bases, the digit scan's
  // warp totals and the NaN count
  return sizeof(uint2) * kThreads * kItems +
         sizeof(unsigned) * (kWarps * kDigits + 2 * kDigits + kDigits / 32 + 1);
}

// Stable ranks of a prefix of at most kThreads values by counting: thread i
// counts rank(i) = #{j : key_j < key_i or (key_j == key_i and j < i)} and
// writes its pair to buf[rank].  z² key compares in one block, no passes.
__device__ __forceinline__ void count_ranks(const float* __restrict__ v, int zf,
                                            unsigned* keys, uint2* buf) {
  const int tid = threadIdx.x;
  const unsigned bits = tid < zf ? __float_as_uint(__ldg(v + tid)) : 0u;
  const unsigned key = sort_key(bits);
  if (tid < zf) keys[tid] = key;
  __syncthreads();
  if (tid < zf) {
    unsigned rank = 0u;
#pragma unroll 8
    for (int j = 0; j < zf; ++j) {
      const unsigned kj = keys[j];
      rank += (kj < key) | ((kj == key) & (j < tid));
    }
    buf[rank] = make_uint2(key, bits);
  }
  __syncthreads();
}

// The radix sort of a row's live prefix over the cluster (see the note at
// the top): `v` is this block's chunk, of which `n` elements are live.
// Leaves the row sorted in the blocks' `buf`, chunk by chunk.
template <int kItems>
__device__ __forceinline__ void radix_passes(const float* __restrict__ v, int n, bool local,
                                             cg::cluster_group& cluster, uint2* buf,
                                             unsigned* whist, unsigned* bhist, unsigned* base,
                                             unsigned* wsum) {
  constexpr int kChunk = kThreads * kItems;
  constexpr int kWarpSpan = 32 * kItems;
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto sync = [&]() {
    if (local) {
      __syncthreads();
    } else {
      cluster.sync();
    }
  };

  unsigned key[kItems], bits[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int i = warp * kWarpSpan + j * 32 + lane;
    bits[j] = i < n ? __float_as_uint(__ldg(v + i)) : 0u;
    key[j] = sort_key(bits[j]);
  }
  const int live_warps = (n + kWarpSpan - 1) / kWarpSpan;
  const unsigned lanes_below = (1u << lane) - 1u;
  unsigned* wh = whist + warp * kDigits;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 8 * pass;
    // 1. ranks among equal digits within the warp, slot by slot
    unsigned off[kItems];
    if (warp < live_warps) {
      for (int d = lane; d < kDigits; d += 32) wh[d] = 0u;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (warp * kWarpSpan + j * 32 < n) {  // the same for the whole warp
          const bool valid = warp * kWarpSpan + j * 32 + lane < n;
          const unsigned d = valid ? (key[j] >> shift) & 0xffu : 0x100u;
          const unsigned peers = __match_any_sync(kFull, d);
          const unsigned before = valid ? wh[d] : 0u;
          off[j] = before + __popc(peers & lanes_below);
          __syncwarp();
          if (valid && (peers & lanes_below) == 0u) wh[d] = before + __popc(peers);
          __syncwarp();
        }
      }
    }
    __syncthreads();
    // 2. per digit: exclusive prefix over the warps, and the block's count
    if (tid < kDigits) {
      unsigned run = 0u;
      for (int w0 = 0; w0 < live_warps; w0 += 8) {
        unsigned c[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) c[u] = w0 + u < live_warps ? whist[(w0 + u) * kDigits + tid] : 0u;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (w0 + u < live_warps) whist[(w0 + u) * kDigits + tid] = run;
          run += c[u];
        }
      }
      bhist[tid] = run;
    }
    sync();  // every block's counts are published
    unsigned total = 0u, earlier = 0u, incl = 0u;
    if (tid < kDigits) {
      if (local) {
        total = bhist[tid];
      } else {
        unsigned c[kMaxCluster];
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          c[q] = q < n_blocks ? cluster.map_shared_rank(bhist, q)[tid] : 0u;
        }
#pragma unroll
        for (int q = 0; q < kMaxCluster; ++q) {
          total += c[q];
          if (q < b) earlier += c[q];
        }
      }
      incl = total;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const unsigned o = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += o;
      }
      if (lane == 31) wsum[warp] = incl;
    }
    __syncthreads();
    if (tid < kDigits) {
      unsigned pre = 0u;
      for (int w = 0; w < warp; ++w) pre += wsum[w];
      base[tid] = pre + incl - total + earlier;
    }
    __syncthreads();
    // 3. every element to its position in the row, in the block that holds it
    if (warp < live_warps) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        if (warp * kWarpSpan + j * 32 + lane < n) {
          const unsigned d = (key[j] >> shift) & 0xffu;
          const unsigned p = base[d] + wh[d] + off[j];
          const uint2 e = make_uint2(key[j], bits[j]);
          if (local) {
            buf[p] = e;
          } else {
            cluster.map_shared_rank(buf, static_cast<int>(p / kChunk))[p % kChunk] = e;
          }
        }
      }
    }
    sync();  // the chunk holds this pass's positions b·kChunk + [0, n)
    if (pass + 1 < kPasses) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int i = warp * kWarpSpan + j * 32 + lane;
        if (i < n) {
          const uint2 e = buf[i];
          key[j] = e.x;
          bits[j] = e.y;
        }
      }
    }
  }

}

template <int kItems>
__global__ void __launch_bounds__(kThreads, 1)
radix_kernel(const float* __restrict__ vals, const int* __restrict__ z,
             const int* __restrict__ targets, float* __restrict__ out, int cap, int r) {
  constexpr int kChunk = kThreads * kItems;
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = static_cast<int>(cluster.num_blocks());
  const int b = static_cast<int>(cluster.block_rank());
  const int f = blockIdx.x / n_blocks;
  const int tid = threadIdx.x;
  const int zf = min(max(z[f], 0), cap);
  const bool local = zf <= kChunk;  // the whole prefix lies in block 0's chunk
  if (local && b > 0) return;
  const int n = min(max(zf - b * kChunk, 0), kChunk);  // live elements of this chunk

  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint2* buf = reinterpret_cast<uint2*>(smem_raw);                // [position]
  unsigned* whist = reinterpret_cast<unsigned*>(buf + kChunk);    // [warp][digit]
  unsigned* bhist = whist + kWarps * kDigits;                     // [digit]
  unsigned* base = bhist + kDigits;                               // [digit]
  unsigned* wsum = base + kDigits;                                // [digit warp]
  unsigned* s_nan = wsum + kDigits / 32;

  const float* row = vals + static_cast<size_t>(f) * cap;
  if (zf <= kCountMax) {
    count_ranks(row, zf, whist, buf);  // a short prefix, in block 0 (local)
  } else {
    radix_passes<kItems>(row + static_cast<size_t>(b) * kChunk, n, local, cluster, buf, whist,
                         bhist, base, wsum);
  }

  // the gather.  The sorted prefix ends with its NaNs; the plain version
  // sorts the row with +inf past z, so position t of its sorted row is the
  // prefix's t-th below z - nan, +inf up to cap - nan, then the NaNs.
  auto at = [&](int p) -> uint2 {
    return local ? buf[p] : cluster.map_shared_rank(buf, p / kChunk)[p % kChunk];
  };
  if (tid == 0) {
    int nan = 0;
    if (zf > 0 && at(zf - 1).x == kNanKey) {
      int lo = 0, hi = zf - 1;  // the first NaN key lies in [lo, hi]
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (at(mid).x == kNanKey) {
          hi = mid;
        } else {
          lo = mid + 1;
        }
      }
      nan = zf - lo;
    }
    *s_nan = static_cast<unsigned>(nan);
  }
  __syncthreads();
  const int nan = static_cast<int>(*s_nan);
  const int share = local ? r : (r + n_blocks - 1) / n_blocks;
  const int q_end = min(r, (local ? 0 : b * share) + share);
  for (int q = (local ? 0 : b * share) + tid; q < q_end; q += kThreads) {
    const int t = min(max(targets[static_cast<size_t>(f) * r + q], 0), cap - 1);
    float o;
    if (t < zf - nan) {
      o = __uint_as_float(at(t).y);
    } else if (t < cap - nan) {
      o = CUDART_INF_F;
    } else {
      o = __uint_as_float(at(t - (cap - zf)).y);
    }
    out[static_cast<size_t>(f) * r + q] = o;
  }
  if (!local) cluster.sync();  // no block leaves while its chunk may be read
}

// -------------------------------------------------------------------- rank
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

bool radix_configured[4][kMaxDevices] = {};

template <int kItems>
int launch_radix(const float* v, const int* zz, const int* t, float* o, int h, int cap, int r,
                 int blocks, int device, cudaStream_t s) {
  constexpr int kSlot = kItems == 1 ? 0 : kItems == 2 ? 1 : kItems == 4 ? 2 : 3;
  constexpr size_t kBytes = radix_smem_bytes<kItems>();
  if (!radix_configured[kSlot][device]) {
    // raised once per card and instance, at the first launch, so that no
    // attribute call falls inside a CUDA-graph capture (callers warm up)
    const cudaError_t err = cudaFuncSetAttribute(
        radix_kernel<kItems>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    radix_configured[kSlot][device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(h) * blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, radix_kernel<kItems>, v, zz, t, o, cap, r);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// items = 0: the rank path (scratch (h, cap) f32).  items = 1, 2, 4 or 8:
// the radix path with clusters of `blocks` (1..8) blocks a row, which must
// cover the row: blocks·1024·items >= cap (scratch unused).
extern "C" int masked_select_ranks_launch(const void* vals, const void* z,
                                          const void* targets, void* scratch,
                                          void* out, int h, int cap, int r, int items,
                                          int blocks, int device, void* stream) {
  if (h < 1 || cap < 1 || r < 1 || device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(vals);
  const auto* zz = static_cast<const int*>(z);
  const auto* t = static_cast<const int*>(targets);
  auto* o = static_cast<float*>(out);
  if (items == 0) {
    const dim3 grid((cap + kTile - 1) / kTile, h);
    rank_scatter_kernel<<<grid, kTile, 0, s>>>(v, zz, static_cast<float*>(scratch), cap);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long total = static_cast<long long>(h) * r;
    gather_kernel<<<static_cast<unsigned>((total + kTile - 1) / kTile), kTile, 0, s>>>(
        static_cast<const float*>(scratch), zz, t, o, h, cap, r);
    return static_cast<int>(cudaGetLastError());
  }
  if (blocks < 1 || blocks > kMaxCluster ||
      static_cast<long long>(blocks) * kThreads * items < cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (items) {
    case 1: return launch_radix<1>(v, zz, t, o, h, cap, r, blocks, device, s);
    case 2: return launch_radix<2>(v, zz, t, o, h, cap, r, blocks, device, s);
    case 4: return launch_radix<4>(v, zz, t, o, h, cap, r, blocks, device, s);
    case 8: return launch_radix<8>(v, zz, t, o, h, cap, r, blocks, device, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
