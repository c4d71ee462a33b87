// flash_attention: blockwise online-softmax attention, causal work skipped.
//
// Replaces the Pallas kernel repro/kernels/flash_attention/flash_attention.py
// (flash_attention, body _kernel): q (B, H, Sq, D), k (B, Hkv, Sk, D),
// v (B, Hkv, Sk, Dv) -> (B, H, Sq, Dv) in q's type.  Scores are taken in
// float32 from q·D^-½ (the scale applied to q, as there); causal scores
// above the diagonal are −1e30 with the mask aligned at the top left (query
// row i sees keys 0..i); the running max, denominator and output
// accumulator are float32; the denominator is clamped at 1e-30.  Query
// head h reads KV head h / (H / Hkv), which equals the reference's repeat
// of the KV heads.  Inputs are float or bf16 (read through the intrinsics,
// which is exact for bf16); the output is written with __float2bfloat16_rn.
// Tensors may be strided views (only the last axis must be contiguous), so
// the model's (B, S, H, D) layout is read and written without transposes.
//
// Design.  One block per (q tile of 32 rows, b·h); the longest causal tiles
// are scheduled first.  The block loops over KV tiles of 64 keys (in place
// of the TPU's sequential third grid axis) and, under causal, stops at the
// tile holding its last row's diagonal: the work above the diagonal is
// never done.  The q tile (pre-scaled) and each K/V tile are staged in
// float32 in shared memory (K rows padded to an odd stride, so a warp's
// lanes read 32 banks).  Each of the 8 warps owns 4 query rows: a lane
// computes the scores of 2 keys × 4 rows with scalar FMAs, the row max and
// sum go through warp shuffles, the probabilities go through shared memory
// and each lane accumulates P·V for Dv/32 output columns in registers.
// Ragged Sq and Sk are masked here; D, Dv <= 256.  Dynamic shared memory:
// 4·(32·D + 64·(D|1) + 64·⌈Dv/32⌉·32 + 8·4·64) bytes, 49 KB at D = Dv = 64.
//
// Bound.  At (1, 16, 4096, 64) causal the function does ≈ 3.4e10 FLOPs
// (the 4096·4097/2 live (q, k) pairs per head, 4·64 FLOPs each): ≈ 0.035 ms
// at the H100's 989 TFLOP/s bf16 tensor-core rate, above its ≈ 33.5 MB of
// q/k/v/o at 3.35 TB/s (≈ 0.010 ms), so it is bound by operations.  At the
// LM-head path's (1, 16, 48, 64) the bound is far below launch latency.
//
// What this simple design leaves on the table: it does its products with
// scalar float32 FMAs out of shared memory (6 shared loads per 8 FMAs, so
// it runs at a fraction of the 67 TFLOP/s float32 rate), while the bound
// assumes the bf16 tensor cores; no mma.sync / wgmma, no TMA or cp.async
// double buffering of the K/V tiles (loads and math do not overlap), K/V
// staged as float32 (twice the shared memory of bf16), and 32-row q tiles
// re-read K/V from L2 once per tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kBlockQ = kWarps * kRowsPerWarp;
constexpr int kBlockK = 64;
constexpr int kMaxDim = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

// Element strides of the batch, head and sequence axes (the last is 1).
struct Strides {
  long long b, h, s;
};

__host__ __device__ __forceinline__ int padded_k_stride(int d) { return d | 1; }

size_t smem_bytes(int d, int dvl) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * d + kBlockK * padded_k_stride(d) +
                          kBlockK * dvl * 32 + kWarps * kRowsPerWarp * kBlockK);
}

template <typename T, int DVL>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, Strides qs, Strides ks,
                       Strides vs, Strides os, int n_heads, int group, int sq, int sk, int d,
                       int dv, int causal, float scale) {
  constexpr int kDvPad = DVL * 32;
  extern __shared__ float smem[];
  const int ldk = padded_k_stride(d);
  float* q_s = smem;                          // (kBlockQ, d), scaled
  float* k_s = q_s + kBlockQ * d;             // (kBlockK, ldk)
  float* v_s = k_s + kBlockK * ldk;           // (kBlockK, kDvPad)
  float* p_s = v_s + kBlockK * kDvPad;        // (kWarps, kRowsPerWarp, kBlockK)

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int b = blockIdx.y / n_heads, h = blockIdx.y % n_heads, hk = h / group;
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
  const float* q_w = q_s + row0 * d;
  float* p_w = p_s + warp * kRowsPerWarp * kBlockK;

  for (int kt = 0; kt < n_kt; ++kt) {
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
  }
}

// The dynamic shared memory limit is raised once per instantiation and card,
// at the first launch, so that no attribute call falls inside a CUDA-graph
// capture (the callers warm up before they capture).
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes = 232448;  // what one block of an H100 may use

template <typename T, int DVL>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, Strides qs,
                   Strides ks, Strides vs, Strides os, int batch, int n_heads, int group,
                   int sq, int sk, int d, int dv, int causal, float scale, int device,
                   cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const size_t bytes = smem_bytes(d, DVL);
  if (bytes > static_cast<size_t>(kMaxSmemBytes) || device < 0 || device >= kMaxDevices) {
    return cudaErrorInvalidValue;
  }
  if (!configured[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, DVL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    configured[device] = true;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, batch * n_heads);
  flash_attention_kernel<T, DVL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, n_heads, group, sq, sk, d, dv, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int dvl, const void* q, const void* k, const void* v, void* o,
                     Strides qs, Strides ks, Strides vs, Strides os, int batch, int n_heads,
                     int group, int sq, int sk, int d, int dv, int causal, float scale,
                     int device, cudaStream_t stream) {
#define FA_CASE(N)                                                                      \
  case N:                                                                               \
    return launch<T, N>(q, k, v, o, qs, ks, vs, os, batch, n_heads, group, sq, sk, d,  \
                        dv, causal, scale, device, stream);
  switch (dvl) {
    FA_CASE(1) FA_CASE(2) FA_CASE(3) FA_CASE(4) FA_CASE(5) FA_CASE(6) FA_CASE(7) FA_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, (batch, head,
// sequence) for each of q, k, v, o; the last axis of each is contiguous.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int batch, int n_heads, int n_kv_heads, int sq, int sk,
    int d, int dv, int causal, float scale, int dtype, int device, void* stream) {
  if (batch < 1 || sq < 1 || sk < 1 || d < 1 || dv < 1 || d > kMaxDim || dv > kMaxDim ||
      n_kv_heads < 1 || n_heads % n_kv_heads != 0 || batch * n_heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss}, vs{v_sb, v_sh, v_ss},
      os{o_sb, o_sh, o_ss};
  const int group = n_heads / n_kv_heads, dvl = (dv + 31) / 32;
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? dispatch<float>(dvl, q, k, v, o, qs, ks, vs, os, batch, n_heads, group,
                                   sq, sk, d, dv, causal, scale, device, s)
      : dtype == 1
          ? dispatch<__nv_bfloat16>(dvl, q, k, v, o, qs, ks, vs, os, batch, n_heads, group,
                                    sq, sk, d, dv, causal, scale, device, s)
          : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
