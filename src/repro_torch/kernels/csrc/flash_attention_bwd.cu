// flash_attention_bwd: the gradient of flash_attention, in two kernels.
//
// Replaces no Pallas kernel: the reference's Pallas flash_attention
// (repro/kernels/flash_attention/flash_attention.py) has no backward, and
// its model takes the attention's gradient by XLA's autodiff of
// attention_full / attention_blockwise (repro/models/lm/layers.py).  The
// port's forward on the card is the flash_attention kernel, whose output
// carries no autograd graph, so its gradient is this pair of kernels
// (kernels/flash_attention/autograd.py).
//
// With the forward's row log-sum-exp L (flash_attention.cu's `lse`) the
// probabilities are recomputed, never stored:
//   P  = exp(scale·Q·Kᵀ − L),          masked entries 0;
//   Δ  = rowsum(dO ∘ O);
//   dS = P ∘ (dO·Vᵀ − Δ);
//   dQ = scale · dS·K,   dK = scale · dSᵀ·Q,   dV = Pᵀ·dO,
// with dK and dV of a KV head summed over the query heads that share it.
// The masks are the forward's: causal (query row i sees keys 0..i, aligned
// at the top left whatever Sk is), a sliding window W > 0 (keys above
// i − W), and keys past Sk.  Tensors are strided views whose last axis is
// contiguous, as the forward takes them; L and Δ are float32 (B, H, Sq)
// contiguous.
//
// flash_attention_bwd_dq: one block of 8 warps per (b·h, tile of 32 query
// rows), the longest causal tiles first.  It computes Δ of its rows (and
// writes it out for the other kernel), then walks the key tiles its rows
// see, 64 keys a tile staged in float32 in shared memory; a warp owns 4
// rows, a lane 2 keys' P and dS and 32-column strides of dQ in registers.
// flash_attention_bwd_dkv: one block of 8 warps per (b·hkv, tile of 32
// keys).  It loops over the query heads of its KV head and, for each, over
// the 64-row query tiles whose rows see its keys, reading Δ from the dQ
// kernel; a warp owns 4 keys, a lane 2 query rows' P and dS and 32-column
// strides of dK and dV.  So a GQA group's sum runs inside one block, in a
// fixed order, and neither kernel uses an atomic: a step gives the same
// bits every time.  The dQ kernel must run first (the wrapper launches
// both on one stream).
//
// Scalar float32 FMAs (bf16 inputs read and widened, float32 accumulated,
// outputs rounded once to the inputs' type); exp is expf.  Bound: the
// backward does about 2.5 times the forward's operations (five products of
// the live (q, k) pairs' size against the forward's two), so on this
// card's bf16 tensor cores it is bound by operations; these SIMT kernels
// run far from that bound, which a wgmma design would close (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"

namespace {

constexpr int kMaxDim = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes = 232448;
constexpr unsigned kMaxGridY = 65535;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                   // rows (dQ) or keys (dK/dV) a warp owns
constexpr int kBlockRows = kWarps * kRows;  // 32 a block
constexpr int kTile = 64;                  // keys (dQ) or query rows (dK/dV) a tile

struct Strides {
  long long b, h, s;
};

struct Problem {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int batch, n_heads, group, sq, sk, d, dv_dim, causal, window;
  float scale;
  int device;
  cudaStream_t stream;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Does query row i see key j?
__device__ __forceinline__ bool live(int i, int j, int sq, int sk, int causal, int window) {
  return i < sq && j < sk && (!causal || j <= i) && (window <= 0 || j > i - window);
}

__host__ __device__ __forceinline__ int odd(int n) { return n | 1; }

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

// ------------------------------------------------------------------- dQ
size_t dq_smem_bytes(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kBlockRows) * (d + dv) +
                          kTile * (odd(d) + odd(dv)) + kWarps * kRows * kTile);
}

// NL: 32-column strides of D a lane accumulates (D <= 32·NL).
template <typename T, int NL>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
          Strides os, Strides dos, Strides dqs, int n_heads, int group, int sq, int sk, int d,
          int dv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int ldk = odd(d), ldv = odd(dv);
  float* q_s = smem;                        // (32, d)
  float* do_s = q_s + kBlockRows * d;       // (32, dv)
  float* k_s = do_s + kBlockRows * dv;      // (64, ldk)
  float* v_s = k_s + kTile * ldk;           // (64, ldv)
  float* ds_s = v_s + kTile * ldv;          // (8 warps, 4 rows, 64 keys)

  const int qt = gridDim.y - 1 - blockIdx.y;  // longest causal tiles first
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads, hk = h / group;
  const int q0 = qt * kBlockRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = warp * kRows;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  const T* ob = o + b * os.b + h * os.h;
  const T* dob = dout + b * dos.b + h * dos.h;
  T* dqb = dq + b * dqs.b + h * dqs.h;
  const long long row_base = static_cast<long long>(bh) * sq;

  for (int i = tid; i < kBlockRows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    q_s[i] = q0 + r < sq ? to_f32(qb[(q0 + r) * qs.s + c]) : 0.f;
  }
  for (int i = tid; i < kBlockRows * dv; i += kThreads) {
    const int r = i / dv, c = i - r * dv;
    do_s[i] = q0 + r < sq ? to_f32(dob[(q0 + r) * dos.s + c]) : 0.f;
  }
  __syncthreads();

  // Δ and L of the warp's rows
  float dl[kRows], lr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qg = q0 + row0 + r;
    float part = 0.f;
    if (qg < sq) {
      for (int c = lane; c < dv; c += 32) part = fmaf(do_s[(row0 + r) * dv + c],
                                                      to_f32(ob[qg * os.s + c]), part);
    }
    dl[r] = warp_sum(part);
    lr[r] = qg < sq ? lse[row_base + qg] : 0.f;
    if (qg < sq && lane == 0) delta[row_base + qg] = dl[r];
  }

  float acc[kRows][NL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < NL; ++c) acc[r][c] = 0.f;
  }

  const int q_last = min(q0 + kBlockRows, sq) - 1;
  int n_kt = (sk + kTile - 1) / kTile;
  if (causal) n_kt = min(n_kt, q_last / kTile + 1);
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kTile : 0;
  float* ds_w = ds_s + warp * kRows * kTile;

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, sk - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      k_s[r * ldk + c] = r < nk ? to_f32(kb[(k0 + r) * ks.s + c]) : 0.f;
    }
    for (int i = tid; i < kTile * dv; i += kThreads) {
      const int r = i / dv, c = i - r * dv;
      v_s[r * ldv + c] = r < nk ? to_f32(vb[(k0 + r) * vs.s + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
    const float* k_lo = k_s + lane * ldk;
    const float* k_hi = k_s + (lane + 32) * ldk;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float a = k_lo[c], a2 = k_hi[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = q_s[(row0 + r) * d + c];
        s[r][0] = fmaf(x, a, s[r][0]);
        s[r][1] = fmaf(x, a2, s[r][1]);
      }
    }
    const float* v_lo = v_s + lane * ldv;
    const float* v_hi = v_s + (lane + 32) * ldv;
#pragma unroll 4
    for (int c = 0; c < dv; ++c) {
      const float a = v_lo[c], a2 = v_hi[c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = do_s[(row0 + r) * dv + c];
        dp[r][0] = fmaf(x, a, dp[r][0]);
        dp[r][1] = fmaf(x, a2, dp[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qg = q0 + row0 + r;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + lane + 32 * e;
        const float p = live(qg, key, sq, sk, causal, window)
                            ? expf(fmaf(s[r][e], scale, -lr[r])) : 0.f;
        ds_w[r * kTile + lane + 32 * e] = p * (dp[r][e] - dl[r]);
      }
    }
    __syncwarp();

    // dQ += dS·K: the lane's columns are lane + 32·c
    for (int j = 0; j < nk; ++j) {
      float kk[NL];
#pragma unroll
      for (int c = 0; c < NL; ++c) {
        const int col = lane + 32 * c;
        kk[c] = col < d ? k_s[j * ldk + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float g = ds_w[r * kTile + j];
#pragma unroll
        for (int c = 0; c < NL; ++c) acc[r][c] = fmaf(g, kk[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qg = q0 + row0 + r;
    if (qg >= sq) continue;
#pragma unroll
    for (int c = 0; c < NL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(dqb + qg * dqs.s + col, acc[r][c] * scale);
    }
  }
}

// ---------------------------------------------------------------- dK, dV
size_t dkv_smem_bytes(int d, int dv) {
  return sizeof(float) * (static_cast<size_t>(kBlockRows) * (d + dv) +
                          kTile * (odd(d) + odd(dv)) + 2 * kWarps * kRows * kTile + 2 * kTile);
}

// NL: 32-column strides of D and of Dv a lane accumulates.
template <typename T, int NL>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv_out,
           Strides qs, Strides ks, Strides vs, Strides dos, Strides dks, Strides dvs,
           int n_heads, int group, int sq, int sk, int d, int dv, int causal, int window,
           float scale) {
  extern __shared__ float smem[];
  const int ldq = odd(d), ldo = odd(dv);
  float* k_s = smem;                        // (32, d)
  float* v_s = k_s + kBlockRows * d;        // (32, dv)
  float* q_s = v_s + kBlockRows * dv;       // (64, ldq)
  float* do_s = q_s + kTile * ldq;          // (64, ldo)
  float* p_s = do_s + kTile * ldo;          // (8 warps, 4 keys, 64 rows)
  float* ds_s = p_s + kWarps * kRows * kTile;
  float* l_s = ds_s + kWarps * kRows * kTile;  // (64,) L of the tile's rows
  float* dl_s = l_s + kTile;                   // (64,) Δ

  const int n_kv = n_heads / group;
  const int b = blockIdx.x / n_kv, hk = blockIdx.x % n_kv;
  const int k0 = blockIdx.y * kBlockRows;  // causal: the first key tiles have the most rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int key0 = warp * kRows;

  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  for (int i = tid; i < kBlockRows * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    k_s[i] = k0 + r < sk ? to_f32(kb[(k0 + r) * ks.s + c]) : 0.f;
  }
  for (int i = tid; i < kBlockRows * dv; i += kThreads) {
    const int r = i / dv, c = i - r * dv;
    v_s[i] = k0 + r < sk ? to_f32(vb[(k0 + r) * vs.s + c]) : 0.f;
  }

  float dk_acc[kRows][NL], dv_acc[kRows][NL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < NL; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;
  }

  // the query rows that see a key of [k0, k0 + 32): causal from k0; a
  // window up to the last key + W − 1
  const int k_last = min(k0 + kBlockRows, sk) - 1;
  const int i_lo = causal ? k0 : 0;
  const int i_hi = window > 0 ? min(sq, k_last + window) : sq;  // exclusive
  float* p_w = p_s + warp * kRows * kTile;
  float* ds_w = ds_s + warp * kRows * kTile;

  for (int hq = 0; hq < group; ++hq) {
    const int h = hk * group + hq;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const long long row_base = (static_cast<long long>(b) * n_heads + h) * sq;
    for (int i0 = i_lo / kTile * kTile; i0 < i_hi; i0 += kTile) {
      const int ni = min(kTile, sq - i0);
      __syncthreads();  // the previous tile's readers are done (and k_s, v_s written)
      for (int i = tid; i < kTile * d; i += kThreads) {
        const int r = i / d, c = i - r * d;
        q_s[r * ldq + c] = r < ni ? to_f32(qb[(i0 + r) * qs.s + c]) : 0.f;
      }
      for (int i = tid; i < kTile * dv; i += kThreads) {
        const int r = i / dv, c = i - r * dv;
        do_s[r * ldo + c] = r < ni ? to_f32(dob[(i0 + r) * dos.s + c]) : 0.f;
      }
      for (int i = tid; i < kTile; i += kThreads) {
        l_s[i] = i < ni ? lse[row_base + i0 + i] : 0.f;
        dl_s[i] = i < ni ? delta[row_base + i0 + i] : 0.f;
      }
      __syncthreads();

      float s[kRows][2], dp[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
      const float* q_lo = q_s + lane * ldq;
      const float* q_hi = q_s + (lane + 32) * ldq;
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        const float a = q_lo[c], a2 = q_hi[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float x = k_s[(key0 + r) * d + c];
          s[r][0] = fmaf(x, a, s[r][0]);
          s[r][1] = fmaf(x, a2, s[r][1]);
        }
      }
      const float* o_lo = do_s + lane * ldo;
      const float* o_hi = do_s + (lane + 32) * ldo;
#pragma unroll 4
      for (int c = 0; c < dv; ++c) {
        const float a = o_lo[c], a2 = o_hi[c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float x = v_s[(key0 + r) * dv + c];
          dp[r][0] = fmaf(x, a, dp[r][0]);
          dp[r][1] = fmaf(x, a2, dp[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int key = k0 + key0 + r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int il = lane + 32 * e;
          const float p = live(i0 + il, key, sq, sk, causal, window)
                              ? expf(fmaf(s[r][e], scale, -l_s[il])) : 0.f;
          p_w[r * kTile + il] = p;
          ds_w[r * kTile + il] = p * (dp[r][e] - dl_s[il]);
        }
      }
      __syncwarp();

      // dV += Pᵀ·dO and dK += dSᵀ·Q: the lane's columns are lane + 32·c
      for (int i = 0; i < ni; ++i) {
        float oo[NL], qq[NL];
#pragma unroll
        for (int c = 0; c < NL; ++c) {
          const int col = lane + 32 * c;
          oo[c] = col < dv ? do_s[i * ldo + col] : 0.f;
          qq[c] = col < d ? q_s[i * ldq + col] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = p_w[r * kTile + i], g = ds_w[r * kTile + i];
#pragma unroll
          for (int c = 0; c < NL; ++c) {
            dv_acc[r][c] = fmaf(p, oo[c], dv_acc[r][c]);
            dk_acc[r][c] = fmaf(g, qq[c], dk_acc[r][c]);
          }
        }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv_out + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int key = k0 + key0 + r;
    if (key >= sk) continue;
#pragma unroll
    for (int c = 0; c < NL; ++c) {
      const int col = lane + 32 * c;
      if (col < d) store(dkb + key * dks.s + col, dk_acc[r][c] * scale);
      if (col < dv) store(dvb + key * dvs.s + col, dv_acc[r][c]);
    }
  }
}

// ------------------------------------------------------------- launchers
template <typename T, int NL>
cudaError_t launch_dq(const Problem& a) {
  static bool configured[kMaxDevices] = {};
  const size_t bytes = dq_smem_bytes(a.d, a.dv_dim);
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(dq_kernel<T, NL>, configured, a.device);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.n_heads, (a.sq + kBlockRows - 1) / kBlockRows);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  dq_kernel<T, NL><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse, a.delta,
      static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.n_heads, a.group, a.sq,
      a.sk, a.d, a.dv_dim, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int NL>
cudaError_t launch_dkv(const Problem& a) {
  static bool configured[kMaxDevices] = {};
  const size_t bytes = dkv_smem_bytes(a.d, a.dv_dim);
  if (bytes > static_cast<size_t>(kMaxSmemBytes)) return cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(dkv_kernel<T, NL>, configured, a.device);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * (a.n_heads / a.group), (a.sk + kBlockRows - 1) / kBlockRows);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  dkv_kernel<T, NL><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.n_heads, a.group, a.sq,
      a.sk, a.d, a.dv_dim, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <template <typename, int> class Launch, typename T>
cudaError_t by_width(const Problem& a, int width) {
  switch ((width + 31) / 32) {
    case 1: return Launch<T, 1>::run(a);
    case 2: return Launch<T, 2>::run(a);
    case 3: return Launch<T, 3>::run(a);
    case 4: return Launch<T, 4>::run(a);
    case 5: return Launch<T, 5>::run(a);
    case 6: return Launch<T, 6>::run(a);
    case 7: return Launch<T, 7>::run(a);
    case 8: return Launch<T, 8>::run(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NL>
struct DQ {
  static cudaError_t run(const Problem& a) { return launch_dq<T, NL>(a); }
};
template <typename T, int NL>
struct DKV {
  static cudaError_t run(const Problem& a) { return launch_dkv<T, NL>(a); }
};

Problem problem(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, float* delta, void* dq, void* dk, void* dv,
                const long long* st, int batch, int n_heads, int n_kv_heads, int sq, int sk,
                int d, int dv_dim, int causal, int window, float scale, int device,
                void* stream) {
  auto s = [&](int i) { return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  return Problem{q, k, v, o, dout, lse, delta, dq, dk, dv,
                 s(0), s(1), s(2), s(3), s(4), s(5), s(6), s(7),
                 batch, n_heads, n_heads / n_kv_heads, sq, sk, d, dv_dim, causal, window, scale,
                 device, static_cast<cudaStream_t>(stream)};
}

bool bad_shape(int batch, int n_heads, int n_kv_heads, int sq, int sk, int d, int dv,
               int window) {
  return batch < 1 || sq < 1 || sk < 1 || d < 1 || dv < 1 || d > kMaxDim || dv > kMaxDim ||
         n_kv_heads < 1 || n_heads % n_kv_heads != 0 || window < 0 ||
         (window > 0 && sq - window >= sk) ||
         static_cast<long long>(batch) * n_heads > 0x7fffffffLL;
}

}  // namespace

// Both entry points take the same arguments.  strides: 24 element strides,
// (batch, head, sequence) of q, k, v, o, dout, dq, dk, dv in that order
// (the last axis of each is contiguous).  lse and delta: (B, H, Sq)
// float32 contiguous; the dQ kernel writes delta, the dK/dV kernel reads
// it, so flash_attention_bwd_dq_launch goes first on the stream.  dtype: 0
// float32, 1 bfloat16 (q, k, v, o, dout and the three gradients alike).
#define FLASH_BWD_ARGS                                                                     \
  const void *q, const void *k, const void *v, const void *o, const void *dout,            \
      const float *lse, float *delta, void *dq, void *dk, void *dv, const long long *strides, \
      int batch, int n_heads, int n_kv_heads, int sq, int sk, int d, int dv_dim, int causal, \
      int window, float scale, int dtype, int device, void *stream

#define FLASH_BWD_PROBLEM                                                                   \
  problem(q, k, v, o, dout, lse, delta, dq, dk, dv, strides, batch, n_heads, n_kv_heads, sq, \
          sk, d, dv_dim, causal, window, scale, device, stream)

extern "C" int flash_attention_bwd_dq_launch(FLASH_BWD_ARGS) {
  if (bad_shape(batch, n_heads, n_kv_heads, sq, sk, d, dv_dim, window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Problem a = FLASH_BWD_PROBLEM;
  const cudaError_t err = dtype == 0   ? by_width<DQ, float>(a, d)
                          : dtype == 1 ? by_width<DQ, __nv_bfloat16>(a, d)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" int flash_attention_bwd_dkv_launch(FLASH_BWD_ARGS) {
  if (bad_shape(batch, n_heads, n_kv_heads, sq, sk, d, dv_dim, window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Problem a = FLASH_BWD_PROBLEM;
  const int width = d > dv_dim ? d : dv_dim;
  const cudaError_t err = dtype == 0   ? by_width<DKV, float>(a, width)
                          : dtype == 1 ? by_width<DKV, __nv_bfloat16>(a, width)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
