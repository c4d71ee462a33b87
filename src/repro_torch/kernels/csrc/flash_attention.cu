// flash_attention: blockwise online-softmax attention, causal and
// sliding-window work skipped.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention, body _kernel): q (B, H, Sq, D), k (B, Hkv, Sk, D),
// v (B, Hkv, Sk, Dv) -> (B, H, Sq, Dv) in q's type.  Causal scores above the
// diagonal are −1e30 with the mask aligned at the top left (query row i sees
// keys 0..i); with a sliding window W > 0, the scores of keys at or below
// i − W are −1e30 too (query row i sees keys i − W < key, and, causal, key
// <= i: the reference's attention_full(window=W) with no q offset).  A
// query tile starts at the first key tile that holds a key above its first
// row's window and so skips the tiles wholly below the window, as it skips
// those wholly above the diagonal; W = 0 is no window.  The running max,
// denominator and output accumulator are float32; the denominator is
// clamped at 1e-30.  Query head h reads KV head h / (H / Hkv), which
// equals the reference's repeat of the KV heads.
// Tensors may be strided views (only the last axis must be contiguous), so
// the model's (B, S, H, D) layout is read and written without transposes.
// Any Sq and Sk; D, Dv <= 256.  Optionally (a non-null `lse`) each query
// row's log-sum-exp of its scaled scores, float32 (B, H, Sq) contiguous:
// the training path's forward saves it for the backward kernels
// (flash_attention_bwd.cu).  Without it, the kernels store nothing else and
// compute exactly what they computed before it existed.
// One entry point, two kernels picked by type:
//
// bf16 (the model's type): `sm90::flash_attention_kernel`, on the tensor
// cores.  One block of three warpgroups per (b·h, q tile of 128 rows), the
// longest causal tiles launched first.  Warpgroup 0 is the producer: it
// gives its registers away (setmaxnreg 40) and one thread loads the q tile
// once and then the K/V tiles of Bc keys into a ring of shared-memory
// stages (3 at DP <= 128, 2 at DP = 256) with TMA (`cp.async.bulk.tensor`,
// tensor maps encoded on the host through cudaGetDriverEntryPoint, so the
// build needs no -lcuda), each stage completing on an mbarrier while the
// consumers compute on the others.  Warpgroups 1 and 2 (setmaxnreg 232) own
// 64 query rows each:
//   S = Q·Kᵀ   wgmma m64nBck16, Q and K both K-major in shared memory;
//   softmax    on the accumulator fragments: the row max over a quad of
//              lanes by two shuffles, p = ex2(s·(log2(e)·D^-½) − m) (one
//              FFMA and one ex2 a score), the mask only on tiles that cross
//              the diagonal, the window's lower edge or the ragged end of
//              Sk;
//   O += P·V   wgmma m64nDvk16 with P from registers (the S fragments
//              rounded to bf16 in place) and V MN-major in shared memory,
//              so V is never transposed;
// tile t's Q·Kᵀ is issued together with tile t−1's P·V, and tile t's
// softmax runs while that P·V is in flight; then each consumer warp
// releases tile t−1's stage.  The two consumers issue their batches of
// wgmma in turns (two named barriers), so that one's softmax runs against
// the other's products.  The first tile is peeled off the loop, and both
// consumers compute every tile of the block (a tile past a warpgroup's
// causal rows is masked whole; a warpgroup wholly past Sq computes on zero
// rows and stores nothing), so no wgmma sits in a data-dependent branch,
// where ptxas would serialize it, and the turns pair up.
// Tiles are 128-byte-swizzled
// panels of 64 columns (what TMA writes and wgmma reads); D and Dv are
// padded with zero columns to DP = 64, 128 or 256 (the larger of the two)
// and Bc = 128 keys at DP <= 128, 64 at DP = 256, so registers and the
// stages fit.  Each DP has two instances: one with the sliding window, and
// one without, whose loop never tests it.
// Rows past Sq or Sk come back from TMA as zeros, and a key
// past Sk is masked, so it adds exactly 0.  Where a view breaks TMA's rules
// (a 16-byte-aligned base, strides that are multiples of 16 bytes), the
// producer warpgroup fills the same ring with plain loads instead: slower,
// still overlapped with the math.  Only those views take the loads: a
// driver without cuTensorMapEncodeTiled, or one that refuses a view within
// the rules, fails the launch, and the entry point reports which path each
// launch took.  Numerics against the plain version
// (float32 throughout, scale on q): the scale is applied to the float32
// scores (exact at D = 64 and 256, where D^-½ is a power of two; a float32
// rounding otherwise), P is rounded to bf16 before P·V (the denominator
// sums the float32 p), ex2.approx has a 2-ulp error, and the summation
// order differs.  The TMA, wgmma, load and tensor-map helpers are in
// hopper.cuh, which the backward kernels (flash_attention_bwd.cu) share.
//
// float32: `simt::flash_attention_kernel`, scalar FMAs.  One block of 8
// warps per (b·h, q tile of 32 rows); 64-key tiles staged in float32 in
// shared memory; each warp owns 4 query rows, a lane 2 keys' scores and
// Dv/32 output columns; scores from q·D^-½ as the reference takes them.
// The port turns TF32 off, and this kernel keeps float32 within summation
// order of the plain version.  It is not on the model's path.
//
// Bound.  At (1, 16, 4096, 64) causal the function does ≈ 3.4e10 FLOPs
// (the 4096·4097/2 live (q, k) pairs per head, 4·64 FLOPs each): ≈ 0.035 ms
// at the H100's 989 TFLOP/s bf16 tensor-core rate, above its ≈ 33.5 MB of
// q/k/v/o at 3.35 TB/s (≈ 0.010 ms), so it is bound by operations; its
// 1.4e8 exponentials take about as long again at 16 ex2 per SM per clock.
// What the bf16 design leaves: the output is stored from registers rather
// than by TMA, the grid is not persistent, and each score still costs an
// FFMA and an ex2.  Measured times are in PERF.md.
#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "async_copy.cuh"
#include "device_guard.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxDim = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes = 232448;  // what one block of an H100 may use
// The grid is (b·h, query tiles): b·h on x, which takes up to 2^31 − 1
// blocks as the reference's first grid axis does; the tiles on y, capped at
// 65535 (8388480 query rows for the bf16 kernel's 128-row tiles).
constexpr unsigned kMaxGridY = 65535;
// The path a launch took, returned through the entry point's `path`.
constexpr int kPathSimt = 0;   // float32: the scalar kernel
constexpr int kPathTma = 1;    // bf16: K/V and Q loaded by TMA
constexpr int kPathLoads = 2;  // bf16: a view TMA cannot read, loaded by the producer

// One call's arguments, as the entry point receives them.
struct Problem {
  const void *q, *k, *v;
  void* o;
  float* lse;  // (B, H, Sq) float32, or null
  Strides qs, ks, vs, os;
  int batch, n_heads, group, sq, sk, d, dv, causal, window;
  float scale;
  int device;
  cudaStream_t stream;
};

// The dynamic shared memory limit is raised once per kernel and card, at
// the first launch, so that no attribute call falls inside a CUDA-graph
// capture (the callers warm up before they capture).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, bool (&configured)[kMaxDevices], int device) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidValue;
  if (!configured[device]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  return cudaSuccess;
}

namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ __forceinline__ int padded_k_stride(int d) { return d | 1; }

size_t smem_bytes(int d, int dvl) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * d + kBlockK * padded_k_stride(d) +
                          kBlockK * dvl * 32 + kWarps * kRowsPerWarp * kBlockK);
}

template <typename T, int DVL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                       Strides qs, Strides ks, Strides vs, Strides os, int n_heads, int group,
                       int sq, int sk, int d, int dv, int causal, int window, float scale) {
  constexpr int kDvPad = DVL * 32;
  extern __shared__ float smem[];
  const int ldk = padded_k_stride(d);
  float* q_s = smem;                          // (kBlockQ, d), scaled
  float* k_s = q_s + kBlockQ * d;             // (kBlockK, ldk)
  float* v_s = k_s + kBlockK * ldk;           // (kBlockK, kDvPad)
  float* p_s = v_s + kBlockK * kDvPad;        // (kWarps, kRowsPerWarp, kBlockK)

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int b = blockIdx.x / n_heads, h = blockIdx.x % n_heads, hk = h / group;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * kRowsPerWarp;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBlockQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    q_s[i] = q0 + r < sq ? to_f32(qb[(q0 + r) * qs.s + c]) * scale : 0.f;
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp], acc[kRowsPerWarp][DVL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DVL; ++c) acc[r][c] = 0.f;
  }

  int n_kt = (sk + kBlockK - 1) / kBlockK;
  if (causal) n_kt = min(n_kt, (min(q0 + kBlockQ, sq) - 1) / kBlockK + 1);
  // the first tile holding a key above row q0's window
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kBlockK : 0;
  const float* q_w = q_s + row0 * d;
  float* p_w = p_s + warp * kRowsPerWarp * kBlockK;

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    const int nk = min(kBlockK, sk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      k_s[r * ldk + c] = r < nk ? to_f32(kb[(k0 + r) * ks.s + c]) : 0.f;
    }
    for (int i = tid; i < kBlockK * kDvPad; i += kThreads) {
      const int r = i / kDvPad, c = i - r * kDvPad;
      v_s[i] = (r < nk && c < dv) ? to_f32(vb[(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();

    // scores of keys (lane, lane + 32) for the warp's rows
    float s[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k_lo = k_s + lane * ldk;
    const float* k_hi = k_s + (lane + 32) * ldk;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float a = k_lo[c], a2 = k_hi[c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float x = q_w[r * d + c];
        s[r][0] = fmaf(x, a, s[r][0]);
        s[r][1] = fmaf(x, a2, s[r][1]);
      }
    }

    const bool in0 = lane < nk, in1 = lane + 32 < nk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int qg = q0 + row0 + r;
      float x0 = s[r][0], x1 = s[r][1];
      if (causal) {
        if (k0 + lane > qg) x0 = kNegInf;
        if (k0 + lane + 32 > qg) x1 = kNegInf;
      }
      if (window > 0) {
        if (k0 + lane <= qg - window) x0 = kNegInf;
        if (k0 + lane + 32 <= qg - window) x1 = kNegInf;
      }
      const float m_new = fmaxf(m_run[r], warp_max(fmaxf(in0 ? x0 : kNegInf,
                                                         in1 ? x1 : kNegInf)));
      const float p0 = in0 ? expf(x0 - m_new) : 0.f;
      const float p1 = in1 ? expf(x1 - m_new) : 0.f;
      const float corr = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * corr + warp_sum(p0 + p1);
      m_run[r] = m_new;
#pragma unroll
      for (int c = 0; c < DVL; ++c) acc[r][c] *= corr;
      p_w[r * kBlockK + lane] = p0;
      p_w[r * kBlockK + lane + 32] = p1;
    }
    __syncwarp();

    // P·V: the lane's output columns are lane + 32·c
    for (int j = 0; j < nk; ++j) {
      float vv[DVL];
#pragma unroll
      for (int c = 0; c < DVL; ++c) vv[c] = v_s[j * kDvPad + lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float p = p_w[r * kBlockK + j];
#pragma unroll
        for (int c = 0; c < DVL; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qg = q0 + row0 + r;
    if (qg >= sq) continue;
    const float l = fmaxf(l_run[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < DVL; ++c) {
      const int col = lane + 32 * c;
      if (col < dv) store(ob + qg * os.s + col, acc[r][c] / l);
    }
    if (lse != nullptr && lane == 0) {
      lse[static_cast<long long>(blockIdx.x) * sq + qg] = m_run[r] + logf(l);
    }
  }
}

template <int DVL>
cudaError_t launch(const Problem& a) {
  static bool configured[kMaxDevices] = {};
  const size_t bytes = smem_bytes(a.d, DVL);
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(flash_attention_kernel<float, DVL>, configured, a.device);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.n_heads, (a.sq + kBlockQ - 1) / kBlockQ);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  flash_attention_kernel<float, DVL><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.qs, a.ks, a.vs, a.os,
      a.n_heads, a.group, a.sq, a.sk, a.d, a.dv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

cudaError_t dispatch(const Problem& a) {
  switch ((a.dv + 31) / 32) {
    case 1: return launch<1>(a);
    case 2: return launch<2>(a);
    case 3: return launch<3>(a);
    case 4: return launch<4>(a);
    case 5: return launch<5>(a);
    case 6: return launch<6>(a);
    case 7: return launch<7>(a);
    case 8: return launch<8>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace simt

namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // warpgroups of 64 query rows each
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 is the producer
constexpr int kBlockQ = 64 * kConsumers;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128·40 + 256·232 = 384·168

// Shared memory of a block for DP, the padded head dim.  Each tile is kept
// as DP / 64 panels of rows x 128 bytes whose 16-byte chunk c of row r sits
// at chunk c ^ (r % 8): what TMA's SWIZZLE_128B writes and a wgmma
// descriptor of layout type 128B reads.  Panels start 1024-byte aligned.
template <int DP>
struct Tile {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kBc = DP <= 128 ? 128 : 64;  // keys per K/V tile
  static constexpr int kStages = DP <= 128 ? 3 : 2;  // K/V stages in the ring
  static constexpr int kQPanelBytes = kBlockQ * 128;
  static constexpr int kKVPanelBytes = kBc * 128;
  static constexpr int kQBytes = kPanels * kQPanelBytes;
  static constexpr int kKBytes = kPanels * kKVPanelBytes;  // and as many for V
  static constexpr int kStageBytes = 2 * kKBytes;
  static constexpr int kSmemBytes = 1024 + kQBytes + kStages * kStageBytes + 8 * (1 + 2 * kStages);
  static_assert(kSmemBytes <= kMaxSmemBytes, "the tiles do not fit in shared memory");
};

struct Params {
  const bf16 *q, *k, *v;
  bf16* o;
  float* lse;  // (B, H, Sq), or null
  Strides qs, ks, vs, os;
  int n_heads, group, sq, sk, d, dv, causal, window;
  int use_tma;   // else the producer warpgroup loads the ring itself
  int o_pairs;   // the output takes aligned bf16x2 stores
  float scale_log2;  // D^-½ · log2(e)
};

// kWindow: the instance that applies p.window; the one without is the
// unwindowed kernel as it was, with no test of the window in its loop.
template <int DP, bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
    flash_attention_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Tile<DP>;
  constexpr int kBc = L::kBc, kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* kv_s = q_s + L::kQBytes;  // stage s: K panels, then V panels
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + kStages * L::kStageBytes);
  uint64_t* full = q_full + 1;        // [kStages]: the stage has arrived
  uint64_t* empty = full + kStages;   // [kStages]: every consumer warp is done with it

  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // longest causal tiles first
  const int b = blockIdx.x / p.n_heads, h = blockIdx.x % p.n_heads, hk = h / p.group;
  const int qk_panels = (p.d + kPanel - 1) / kPanel, v_panels = (p.dv + kPanel - 1) / kPanel;
  int n_kt = (p.sk + kBc - 1) / kBc;
  if (p.causal) n_kt = min(n_kt, (min(q0 + kBlockQ, p.sq) - 1) / kBc + 1);
  // Tiles kt0 .. n_kt − 1 hold the block's keys: kt0 is the first with a
  // key above row q0's window.  The loops below count tiles t from 0 (the
  // ring's stages and phases), tile t holding keys from (kt0 + t)·Bc.
  const int window = kWindow ? p.window : 0;
  const int kt0 = kWindow ? max(0, q0 - window + 1) / kBc : 0;
  const int n_t = n_kt - kt0;

  // panels wholly past D or Dv are never loaded: zero columns, once
  zero_smem<kThreads>(q_s + qk_panels * L::kQPanelBytes,
                      (L::kPanels - qk_panels) * L::kQPanelBytes);
  for (int s = 0; s < kStages; ++s) {
    uint8_t* k_st = kv_s + s * L::kStageBytes;
    zero_smem<kThreads>(k_st + qk_panels * L::kKVPanelBytes,
                        (L::kPanels - qk_panels) * L::kKVPanelBytes);
    zero_smem<kThreads>(k_st + L::kKBytes + v_panels * L::kKVPanelBytes,
                        (L::kPanels - v_panels) * L::kKVPanelBytes);
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (p.use_tma) {
      if (tid == 0) {
        mbar_expect_tx(q_full, qk_panels * L::kQPanelBytes);
        for (int pn = 0; pn < qk_panels; ++pn) {
          tma_load(q_s + pn * L::kQPanelBytes, &tq, q_full, pn * kPanel, q0, h, b);
        }
        for (int t = 0; t < n_t; ++t) {
          const int s = t % kStages, row = (kt0 + t) * kBc;
          if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
          uint8_t* k_st = kv_s + s * L::kStageBytes;
          uint8_t* v_st = k_st + L::kKBytes;
          mbar_expect_tx(&full[s], (qk_panels + v_panels) * L::kKVPanelBytes);
          for (int pn = 0; pn < qk_panels; ++pn) {
            tma_load(k_st + pn * L::kKVPanelBytes, &tk, &full[s], pn * kPanel, row, hk, b);
          }
          for (int pn = 0; pn < v_panels; ++pn) {
            tma_load(v_st + pn * L::kKVPanelBytes, &tv, &full[s], pn * kPanel, row, hk, b);
          }
        }
      }
    } else {
      const bf16* qb = p.q + b * p.qs.b + h * p.qs.h;
      const bf16* kb = p.k + b * p.ks.b + hk * p.ks.h;
      const bf16* vb = p.v + b * p.vs.b + hk * p.vs.h;
      load_tile(q_s, qb, p.qs.s, q0, p.sq, p.d, kBlockQ, qk_panels, tid);
      publish(q_full, tid);
      for (int t = 0; t < n_t; ++t) {
        const int s = t % kStages, row = (kt0 + t) * kBc;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        uint8_t* k_st = kv_s + s * L::kStageBytes;
        load_tile(k_st, kb, p.ks.s, row, p.sk, p.d, kBc, qk_panels, tid);
        load_tile(k_st + L::kKBytes, vb, p.vs.s, row, p.sk, p.dv, kBc, v_panels, tid);
        publish(&full[s], tid);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
    const int row_base = q0 + 64 * cw;
    const int r0 = row_base + 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const bool active = row_base < p.sq;
    // Both consumers compute all n_t tiles of the block (a tile past a
    // warpgroup's causal rows or below its window is masked whole and adds
    // 0), and a warpgroup wholly past Sq computes on zero rows and stores
    // nothing: no branch holds a wgmma, and the two take equal turns below.
    const uint8_t* q_w = q_s + cw * 64 * 128;
    auto k_stage = [&](int t) { return kv_s + (t % kStages) * L::kStageBytes; };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[t % kStages]);
    };
    // The consumers issue their batches of wgmma in turns (named barrier
    // 2 + w is warpgroup w's turn), so that one's softmax runs against the
    // other's products; consumer 0 starts.
    auto wait_turn = [&]() { asm volatile("bar.sync %0, 256;" ::"r"(2 + cw) : "memory"); };
    auto pass_turn = [&]() { asm volatile("bar.arrive %0, 256;" ::"r"(3 - cw) : "memory"); };

    float o[DP / 2], sc[kBc / 2];
    uint32_t pa[kBc / 16][4];  // a tile's P, bf16 pairs as wgmma's A operand
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2], sum[2];

    // S = Q·Kᵀ of tile t into sc, 16 columns of D a step
    auto issue_s = [&](int t) {
      const uint8_t* k_st = k_stage(t);
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const int pn = ks / 4, off = (ks % 4) * 32;
        mma_ss<kBc>(sc, desc(q_w + pn * L::kQPanelBytes + off, 16, 1024),
                    desc(k_st + pn * L::kKVPanelBytes + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
    };
    // O += P·V of tile t, 16 keys a step; V panels are 64 columns of Dv apart
    auto issue_pv = [&](int t) {
      const uint8_t* v_st = k_stage(t) + L::kKBytes;
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        mma_rs<DP>(o, pa[kk], desc(v_st + kk * 16 * 128, L::kKVPanelBytes, 1024), 1);
      }
      wgmma_commit();
    };
    // The online softmax of tile t: masks sc, moves the running max m and
    // leaves P = 2^(S·scale·log2(e) − m) in sc, the rescale of the earlier
    // tiles in corr and the tile's row sums (of this thread) in sum.
    // sc[4j + e] is (row r0 + 8·(e / 2), key k0 + 8j + 2·(lane % 4) + e % 2).
    auto softmax = [&](int t) {
      const int k0 = (kt0 + t) * kBc;
      if (k0 + kBc > p.sk || (p.causal && k0 + kBc - 1 > row_base) ||
          (kWindow && k0 <= row_base + 63 - window)) {
#pragma unroll
        for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (key >= p.sk || (p.causal && key > row) || (kWindow && key <= row - window)) {
              sc[4 * j + e] = -INFINITY;
            }
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, neg_m[2];
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * p.scale_log2);
        neg_m[r] = m_new == -INFINITY ? 0.f : -m_new;
        corr[r] = ex2(m[r] + neg_m[r]);
        m[r] = m_new;
        sum[r] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBc / 2; ++i) {
        sc[i] = ex2(fmaf(sc[i], p.scale_log2, neg_m[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += sc[i];
      }
    };
    // after the tile's P·V has landed: rescale, and P of the new tile to bf16
    auto rescale_and_pack = [&]() {
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) {
        pa[j / 2][(j % 2) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
      }
    };

    if (cw == 1) pass_turn();
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    wait_turn();
    wgmma_fence();
    issue_s(0);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(0);
    rescale_and_pack();
    // Tile t's Q·Kᵀ is issued together with tile t − 1's P·V, and tile
    // t's softmax runs while that P·V is in flight.
    for (int t = 1; t < n_t; ++t) {
      mbar_wait(&full[t % kStages], (t / kStages) & 1);
      wait_turn();
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      pass_turn();
      wgmma_wait<1>();
      fence_regs(sc);
      softmax(t);
      wgmma_wait<0>();
      fence_regs(o);
      release(t - 1);
      rescale_and_pack();
    }
    wait_turn();
    wgmma_fence();
    issue_pv(n_t - 1);
    if (cw == 0) pass_turn();  // consumer 1's last batch hands no turn back
    wgmma_wait<0>();
    fence_regs(o);
    release(n_t - 1);

    if (!active) return;
    bf16* ob = p.o + b * p.os.b + h * p.os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    if (p.lse != nullptr && lane % 4 == 0) {
      // m is in the base-2 domain of the scaled scores: lse = ln 2 · (m + log2 l)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row < p.sq) {
          p.lse[static_cast<long long>(blockIdx.x) * p.sq + row] =
              0.6931471805599453f * (m[r] + log2f(l[r]));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col >= p.dv) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        if (row >= p.sq) continue;
        const float x0 = o[4 * j + 2 * r] / l[r], x1 = o[4 * j + 2 * r + 1] / l[r];
        bf16* dst = ob + row * p.os.s + col;
        if (p.o_pairs) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
        } else {
          dst[0] = __float2bfloat16_rn(x0);
          if (col + 1 < p.dv) dst[1] = __float2bfloat16_rn(x1);
        }
      }
    }
  }
}

template <int DP, bool kWindow>
cudaError_t launch(const Problem& a, int* path) {
  using L = Tile<DP>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(flash_attention_kernel<DP, kWindow>, configured, a.device);
  if (err != cudaSuccess) return err;
  const int hkv = a.n_heads / a.group;
  const TmaView vq = tma_view(a.q, a.d, a.sq, a.n_heads, a.batch, a.qs);
  const TmaView vk = tma_view(a.k, a.d, a.sk, hkv, a.batch, a.ks);
  const TmaView vv = tma_view(a.v, a.dv, a.sk, hkv, a.batch, a.vs);
  const bool tma = vq.ok && vk.ok && vv.ok;
  CUtensorMap tq{}, tk{}, tv{};
  if (tma) {
    err = encode(&tq, a.q, vq, kBlockQ);
    if (err == cudaSuccess) err = encode(&tk, a.k, vk, L::kBc);
    if (err == cudaSuccess) err = encode(&tv, a.v, vv, L::kBc);
    if (err != cudaSuccess) return err;
  }
  Params p;
  p.q = static_cast<const bf16*>(a.q);
  p.k = static_cast<const bf16*>(a.k);
  p.v = static_cast<const bf16*>(a.v);
  p.o = static_cast<bf16*>(a.o);
  p.lse = a.lse;
  p.qs = a.qs, p.ks = a.ks, p.vs = a.vs, p.os = a.os;
  p.n_heads = a.n_heads, p.group = a.group, p.sq = a.sq, p.sk = a.sk, p.d = a.d, p.dv = a.dv;
  p.causal = a.causal;
  p.window = a.window;
  p.use_tma = tma;
  p.o_pairs = a.dv % 2 == 0 && a.os.s % 2 == 0 && a.os.h % 2 == 0 && a.os.b % 2 == 0 &&
              reinterpret_cast<uintptr_t>(a.o) % 4 == 0;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  const dim3 grid(a.batch * a.n_heads, (a.sq + kBlockQ - 1) / kBlockQ);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  flash_attention_kernel<DP, kWindow><<<grid, kThreads, L::kSmemBytes, a.stream>>>(tq, tk, tv, p);
  *path = tma ? kPathTma : kPathLoads;
  return cudaGetLastError();
}

template <bool kWindow>
cudaError_t dispatch_dp(const Problem& a, int* path) {
  const int dp = std::max(a.d, a.dv);
  return dp <= 64    ? launch<64, kWindow>(a, path)
         : dp <= 128 ? launch<128, kWindow>(a, path)
                     : launch<256, kWindow>(a, path);
}

cudaError_t dispatch(const Problem& a, int* path) {
  return a.window > 0 ? dispatch_dp<true>(a, path) : dispatch_dp<false>(a, path);
}

}  // namespace sm90

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, head,
// sequence) for each of q, k, v, o; the last axis of each is contiguous.
// window: 0, or W > 0 with Sq − W < Sk, so that every query row has a key
// in its window (a block whose rows have none would have no tile to run).
// *path tells which kernel and load path a successful launch took:
// kPathSimt, kPathTma or kPathLoads.  lse: null, or (B, H, Sq) float32
// contiguous for each query row's log-sum-exp (natural log) of its scaled
// scores.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int batch, int n_heads, int n_kv_heads, int sq, int sk,
    int d, int dv, int causal, int window, float scale, int dtype, int device, void* stream,
    int* path, float* lse) {
  if (batch < 1 || sq < 1 || sk < 1 || d < 1 || dv < 1 || d > kMaxDim || dv > kMaxDim ||
      n_kv_heads < 1 || n_heads % n_kv_heads != 0 || window < 0 ||
      (window > 0 && sq - window >= sk) ||
      static_cast<long long>(batch) * n_heads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Problem a{q, k, v, o, lse,
                  {q_sb, q_sh, q_ss}, {k_sb, k_sh, k_ss}, {v_sb, v_sh, v_ss}, {o_sb, o_sh, o_ss},
                  batch, n_heads, n_heads / n_kv_heads, sq, sk, d, dv, causal, window, scale,
                  device,
                  static_cast<cudaStream_t>(stream)};
  *path = kPathSimt;
  const cudaError_t err = dtype == 0   ? simt::dispatch(a)
                          : dtype == 1 ? sm90::dispatch(a, path)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
