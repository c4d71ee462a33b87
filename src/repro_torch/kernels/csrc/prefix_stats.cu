// prefix_power_sums: inclusive prefix sums of (v - shift)^p, p = 1..4.
//
// Replaces the Pallas kernel repro/kernels/sampled_agg/prefix_stats.py
// (prefix_power_sums, body _prefix_kernel): (k, cap) f32 values and a (k,)
// shift -> (k, cap, 4) f32 tables, compensated so that a 60k-row
// heavy-tailed column keeps double-precision-class accuracy.  Every sum is
// an unevaluated (hi, lo) pair combined by two-sum (compensated.cuh), and
// collapses to hi + lo only when it is written.
//
// Two paths, chosen by the wrapper (kernels/sampled_agg/prefix_stats.py):
//
// chunks (`chunked_kernel`): each row is cut into chunks of 4·kThreads
// columns (1024, or 2048 where a row would have more than 32), one block a
// chunk, so that k × chunks blocks fill the card: 288 at (9, 32768), 96 at
// (3, 65536).  A block
//   1. takes its chunk id from an atomic ticket, so that chunks start in id
//      order and a block only ever waits on chunks already running;
//   2. loads 4 columns a thread (one 16-byte load where the row allows),
//      scans them in the thread, then the thread totals by a warp scan of
//      shuffles, then the warp totals in shared memory;
//   3. publishes the chunk's four (hi, lo) totals with a flag;
//   4. waits for the totals of chunks 0..c-1 of its row and folds them in
//      index order (warp scans over 32 at a time, in a fixed pattern, then
//      in sequence), so the carry, and so the table, is the same at every
//      launch: the serving loop's plans depend on it;
//   5. combines the carry in front of each column, stages the (chunk, 4)
//      tile in shared memory and writes it with one bulk copy.
// The ticket, flags and totals live in a launch state of the wrapper,
// zeroed once, which two launches that may overlap never share: one per
// stream for eager launches, one per captured graph for a graph's.  The
// flags are tagged with the state's epoch, which the block that takes a
// launch's last ticket advances (and resets the ticket), so no memset runs
// before a call, and a graph that replays the launch finds the state as
// its previous launch left it.
//
// rows (`rows_kernel`, the earlier design): one block a row walks its 1024-
// column tiles in turn with a running carry.  It needs no state; it runs
// only when asked for (chunk_threads = 0), as the earlier design's
// yardstick.
//
// Bound.  At k = 9, cap = 32768 the kernel must read 1.2 MB and write
// 4.7 MB: about 1.8 us at 3.35 TB/s, so bytes bound it.  Each chunk's
// carry needs only its predecessors' totals, not their prefixes, so no
// chain of blocks forms; what is left is the launch and one round of
// flags.
#include <cuda_runtime.h>

#include "async_copy.cuh"
#include "compensated.cuh"
#include "device_guard.cuh"

namespace {

constexpr int kCols = 4;  // columns a thread of the chunked kernel
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void warp_scan(float& hi, float& lo, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const float ohi = __shfl_up_sync(kFull, hi, s);
    const float olo = __shfl_up_sync(kFull, lo, s);
    if (lane >= s) comp_combine(ohi, olo, hi, lo, hi, lo);
  }
}

// ------------------------------------------------------------------ chunks
// The launch state, in device memory (int32 words): one 64-bit word of
// ticket (low half) and epoch (high half), taken by a single atomic so that
// a block reads the epoch of the launch it belongs to; then a flag and the
// four (hi, lo) totals for each chunk slot.
struct State {
  unsigned long long ticket_epoch;
  unsigned pad[6];
};
constexpr int kHeaderWords = 8;

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// The running compensated sums of the four powers over a thread's columns
// 0..last, in column order.
__device__ __forceinline__ void local_scan(const float (&x)[kCols], float sh, int last,
                                           float (&hi)[4], float (&lo)[4]) {
  float p[4];
  powers4(x[0], sh, hi);
#pragma unroll
  for (int q = 0; q < 4; ++q) lo[q] = 0.f;
#pragma unroll
  for (int j = 1; j < kCols; ++j) {
    if (j > last) break;
    powers4(x[j], sh, p);
#pragma unroll
    for (int q = 0; q < 4; ++q) comp_combine(hi[q], lo[q], p[q], 0.f, hi[q], lo[q]);
  }
}

// At most 64 registers a thread, so that 2048 threads of blocks fit an SM.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
chunked_kernel(const float* __restrict__ vals, const float* __restrict__ shift,
               float4* __restrict__ out, int cap, int chunks_per_row, int n_blocks,
               int vec_loads, unsigned* __restrict__ state, int slots) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunk = kThreads * kCols;
  __shared__ __align__(128) float4 tile[kChunk];
  __shared__ float wt_hi[4][kWarps], wt_lo[4][kWarps];
  __shared__ float carry_hi[4], carry_lo[4];
  __shared__ int s_id;
  __shared__ unsigned s_tag;

  State* st = reinterpret_cast<State*>(state);
  unsigned* flags = state + kHeaderWords;
  float* totals = reinterpret_cast<float*>(flags + slots);  // [slot][hi0..3, lo0..3]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    const unsigned long long te = atomicAdd(&st->ticket_epoch, 1ull);
    const int ticket = static_cast<int>(te & 0xffffffffu);
    const unsigned tag = static_cast<unsigned>(te >> 32) + 1u;
    s_id = ticket;
    s_tag = tag;
    if (ticket == n_blocks - 1) {
      // every ticket of this launch is taken: ready the next launch's word,
      // its epoch advanced (a tag is never 0, the zeroed flags' value)
      st->ticket_epoch = static_cast<unsigned long long>(tag == 0xffffffffu ? 0u : tag) << 32;
    }
  }
  __syncthreads();
  const int id = s_id;
  const unsigned tag = s_tag;
  const int row = id / chunks_per_row, chunk = id % chunks_per_row;
  const int c0 = chunk * kChunk;
  const int n = min(kChunk, cap - c0);
  const float* v = vals + static_cast<size_t>(row) * cap + c0;
  const float sh = shift[row];

  // 1. the thread's four columns, scanned in the thread; columns past cap
  //    are the shift, whose powers are exact zeros
  const int col = tid * kCols;
  float x[kCols];
  if (vec_loads && col + kCols <= n) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(v + col));
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] = col + j < n ? v[col + j] : sh;
  }
  // (the running sums are taken again in step 5 rather than kept in
  // registers: the same operations, so the same bits)
  float th_all[4], tl_all[4];
  local_scan(x, sh, kCols - 1, th_all, tl_all);
  // 2. the thread totals by a warp scan; the thread keeps its exclusive prefix
  float ex_hi[4], ex_lo[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float th = th_all[q], tl = tl_all[q];
    warp_scan(th, tl, lane);
    ex_hi[q] = __shfl_up_sync(kFull, th, 1);
    ex_lo[q] = __shfl_up_sync(kFull, tl, 1);
    if (lane == 0) ex_hi[q] = 0.f, ex_lo[q] = 0.f;
    if (lane == 31) wt_hi[q][warp] = th, wt_lo[q][warp] = tl;
  }
  __syncthreads();
  if (warp == 0) {
    // the warp totals scanned by warp 0 (lanes past kWarps add zeros)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float th = lane < kWarps ? wt_hi[q][lane] : 0.f;
      float tl = lane < kWarps ? wt_lo[q][lane] : 0.f;
      warp_scan(th, tl, lane);
      if (lane < kWarps) wt_hi[q][lane] = th, wt_lo[q][lane] = tl;
    }
    __syncwarp();
    // 3. publish the chunk total (slot = ticket id)
    if (lane == 0) {
      float* t = totals + static_cast<size_t>(id) * 8;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        t[q] = wt_hi[q][kWarps - 1];
        t[4 + q] = wt_lo[q][kWarps - 1];
      }
      st_release(flags + id, tag);  // orders the totals' stores before the flag
    }
    // 4. fold the totals of chunks 0..chunk-1 of the row in index order
    float c_hi[4] = {0.f, 0.f, 0.f, 0.f}, c_lo[4] = {0.f, 0.f, 0.f, 0.f};
    const int first = id - chunk;  // the row's chunk 0
    for (int base = 0; base < chunk; base += 32) {
      const int pred = base + lane;
      float g_hi[4] = {0.f, 0.f, 0.f, 0.f}, g_lo[4] = {0.f, 0.f, 0.f, 0.f};
      if (pred < chunk) {
        while (ld_acquire(flags + first + pred) != tag) {
        }
        const float* t = totals + static_cast<size_t>(first + pred) * 8;
#pragma unroll
        for (int q = 0; q < 4; ++q) g_hi[q] = __ldcg(t + q), g_lo[q] = __ldcg(t + 4 + q);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        warp_scan(g_hi[q], g_lo[q], lane);
        const float s_hi = __shfl_sync(kFull, g_hi[q], 31);
        const float s_lo = __shfl_sync(kFull, g_lo[q], 31);
        comp_combine(c_hi[q], c_lo[q], s_hi, s_lo, c_hi[q], c_lo[q]);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) carry_hi[q] = c_hi[q], carry_lo[q] = c_lo[q];
    }
  }
  __syncthreads();
  // 5. carry, earlier warps and earlier lanes in front of each column
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float p_hi = ex_hi[q], p_lo = ex_lo[q];
    if (warp > 0) comp_combine(wt_hi[q][warp - 1], wt_lo[q][warp - 1], p_hi, p_lo, p_hi, p_lo);
    comp_combine(carry_hi[q], carry_lo[q], p_hi, p_lo, ex_hi[q], ex_lo[q]);
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    float hi[4], lo[4], res[4];
    local_scan(x, sh, j, hi, lo);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float h, l;
      comp_combine(ex_hi[q], ex_lo[q], hi[q], lo[q], h, l);
      res[q] = __fadd_rn(h, l);
    }
    tile[col + j] = make_float4(res[0], res[1], res[2], res[3]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    bulk_store(out + static_cast<size_t>(row) * cap + c0, tile,
               static_cast<uint32_t>(n) * sizeof(float4));
  }
}

// -------------------------------------------------------------------- rows
constexpr int kRowThreads = 1024;
constexpr int kRowWarps = kRowThreads / 32;

__global__ void __launch_bounds__(kRowThreads)
rows_kernel(const float* __restrict__ vals, const float* __restrict__ shift,
            float4* __restrict__ out, int cap) {
  __shared__ float tot_hi[4][kRowWarps];
  __shared__ float tot_lo[4][kRowWarps];
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* v = vals + static_cast<size_t>(row) * cap;
  float4* o = out + static_cast<size_t>(row) * cap;
  const float sh = shift[row];
  float carry_hi[4] = {0.f, 0.f, 0.f, 0.f};
  float carry_lo[4] = {0.f, 0.f, 0.f, 0.f};

  for (int base = 0; base < cap; base += kRowThreads) {
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
      comp_combine(carry_hi[q], carry_lo[q], tot_hi[q][kRowWarps - 1],
                   tot_lo[q][kRowWarps - 1], carry_hi[q], carry_lo[q]);
    }
    if (c < cap) o[c] = make_float4(res[0], res[1], res[2], res[3]);
    __syncthreads();  // the totals are rewritten by the next tile
  }
}

template <int kThreads>
cudaError_t launch_chunks(const float* vals, const float* shift, float4* out, int k, int cap,
                          unsigned* state, int slots, cudaStream_t stream) {
  constexpr int kChunk = kThreads * kCols;
  const int chunks_per_row = (cap + kChunk - 1) / kChunk;
  const long long blocks = static_cast<long long>(k) * chunks_per_row;
  if (blocks > slots) return cudaErrorInvalidValue;
  const int vec = cap % kCols == 0 && reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  chunked_kernel<kThreads><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      vals, shift, out, cap, chunks_per_row, static_cast<int>(blocks), vec, state, slots);
  return cudaGetLastError();
}

}  // namespace

// chunk_threads: 512 or 256 (chunks of 2048 or 1024 columns) for the
// chunked kernel, whose `state` holds `slots` ≥ k × chunks chunk slots
// (laid out as State, flags, totals), must be zeroed before its first
// launch and must never be used by two launches that may overlap; 0 for the
// rows kernel (state unused).  `out` must be 16-byte aligned.
extern "C" int prefix_power_sums_launch(const void* vals, const void* shift, void* out, int k,
                                        int cap, int chunk_threads, void* state, int slots,
                                        int device, void* stream) {
  if (k < 1 || cap < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const auto* v = static_cast<const float*>(vals);
  const auto* s = static_cast<const float*>(shift);
  auto* o = static_cast<float4*>(out);
  auto* st = static_cast<unsigned*>(state);
  const auto strm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (chunk_threads) {
    case 0:
      rows_kernel<<<k, kRowThreads, 0, strm>>>(v, s, o, cap);
      err = cudaGetLastError();
      break;
    case 256: err = launch_chunks<256>(v, s, o, k, cap, st, slots, strm); break;
    case 512: err = launch_chunks<512>(v, s, o, k, cap, st, slots, strm); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// The id of the CUDA graph capture under way on `stream`, plus one (0 when
// the stream is not capturing), so that the wrapper keeps one launch state
// per captured graph.
extern "C" int prefix_power_sums_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long capture = 0;
  const cudaError_t err =
      cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &capture);
  *id = err == cudaSuccess && status == cudaStreamCaptureStatusActive ? capture + 1 : 0;
  return static_cast<int>(err);
}
