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
// One entry point a kernel; the type picks the design, and `path` reports
// which design and load path a launch took (kPathSimt, kPathTma,
// kPathLoads, as in flash_attention.cu).  The dQ kernel writes Δ, which the
// dK/dV kernel reads, so it runs first (the wrapper launches both on one
// stream).  A GQA group's sum stays inside one block in a fixed order, and
// neither kernel uses an atomic: a step gives the same bits every time.
//
// bf16 (the model's type): `sm90::dq_kernel`, then `sm90::dkv_kernel`, on
// the tensor cores, built from the forward's pieces (hopper.cuh).  A block
// is three warpgroups: warpgroup 0 the producer (setmaxnreg 40), one of
// whose threads loads tiles by TMA into a ring of shared-memory stages that
// complete on mbarriers (where a view breaks TMA's rules, its 128 threads
// fill the same ring with plain loads), warpgroups 1 and 2 the consumers
// (setmaxnreg 232).  Tiles are the forward's 128-byte-swizzled panels of 64
// columns, zero past D or Dv.
//   dq_kernel: a block per (b·h, 128 query rows), the longest causal tiles
//   first, 64 rows a consumer.  Before its loop a consumer warp computes Δ
//   of its 16 rows from O and dO (every row's loads issued before the first
//   sum) and writes it out.  Then, for each tile of
//   Bc keys its rows see (K and V streamed through the ring; Bc = 64, 32 at
//   D = 256):
//     S = Q·Kᵀ, dP = dO·Vᵀ   wgmma, Q, dO, K and V K-major in shared memory;
//     P = 2^(S·D^-½·log2(e) − L·log2(e)), dS = P ∘ (dP − Δ) on the
//                            fragments (one FFMA and one ex2.approx a score;
//                            masks only on tiles that cross the diagonal,
//                            the window's lower edge or the end of Sk);
//     dQ += dS·K             wgmma with dS from registers rounded to bf16 and
//                            K read MN-major, so it is never transposed.
//   dkv_kernel: a block per (b·hkv, 64 keys), K and V loaded once; it walks
//   the query heads of its KV head in order and, for each, the tiles of Br
//   query rows that see its keys, Q, dO, L·log2(e) and Δ streamed:
//     Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ wgmma, the keys as the 64 rows;
//     Pᵀ, dSᵀ                in registers, rounded to bf16;
//     dV += Pᵀ·dO, dK += dSᵀ·Q  wgmma with A from registers, dO and Q read
//                            MN-major.
//   Where dK and dV fit one thread together (D + Dv <= 256) both consumers
//   accumulate both over alternate tiles (Br = 64; 32 at 128/128) and the
//   second's sums are added to the first's through shared memory at the
//   end; else (MLA's 192/128, 256/256) consumer 0 accumulates dK and
//   consumer 1 dV over every tile, each computing Sᵀ (Br = 64 at 192/128, 32
//   at 256).  The accumulators are as wide as the training path's head dims
//   (instances 64, 80, 128, 192/128 and 256/256: wgmma takes N = 80 and
//   192); another head dim takes the next instance, its extra columns zero.
//   Numerics against the plain version (float32 throughout): P and dS are
//   rounded to bf16 before the products, exp is ex2.approx (2 ulps), and
//   the summation order differs; kernels/flash_attention/emulation.py's
//   bf16_backward reproduces the roundings and the tile order.
//
// float32: `dq_kernel<float>`, `dkv_kernel<float>`, scalar FMAs.  dQ: one
// block of 8 warps per (b·h, tile of 32 query rows); it computes Δ of its
// rows, then walks the key tiles its rows see, 64 keys a tile staged in
// shared memory; a warp owns 4 rows, a lane 2 keys' P and dS and 32-column
// strides of dQ in registers.  dK/dV: one block of 8 warps per (b·hkv, tile
// of 32 keys), looping over the query heads of its KV head and, for each,
// over the 64-row query tiles whose rows see its keys; a warp owns 4 keys,
// a lane 2 query rows' P and dS and 32-column strides of dK and dV.  exp is
// expf.  It is not on the model's path.
//
// Bound: the backward does about 2.5 times the forward's operations (five
// products of the live (q, k) pairs' size against the forward's two), so on
// this card's bf16 tensor cores it is bound by operations at the training
// shapes.  The pair computes seven products (S and dP twice), and the roles
// instances eight.  What the bf16 design leaves: a consumer waits on each
// of its two batches of wgmma a tile, and only the other consumer's work
// fills the gap (issuing a tile's S and dP with the previous tile's
// gradient products, as the forward does, gave the same times); each
// block pays its first tiles' loads, as the grid is not persistent (a GQA
// shape's dK/dV grid is small: qwen3-8b's is 8 KV heads x 16 = 128
// blocks); the gradients are stored from registers.  Measured times are in
// PERF.md.
#include <cuda.h>  // CUtensorMap and its enums only: the driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "async_copy.cuh"
#include "device_guard.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxDim = 256;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes = 232448;
constexpr unsigned kMaxGridY = 65535;
// The path a launch took, returned through the entry point's `path`.
constexpr int kPathSimt = 0;   // float32: the scalar kernel
constexpr int kPathTma = 1;    // bf16: tiles loaded by TMA
constexpr int kPathLoads = 2;  // bf16: a view TMA cannot read, loaded by the producer
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;                   // rows (dQ) or keys (dK/dV) a warp owns
constexpr int kBlockRows = kWarps * kRows;  // 32 a block
constexpr int kTile = 64;                  // keys (dQ) or query rows (dK/dV) a tile

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
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ------------------------------------------------------- bf16: tensor cores
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);  // warpgroup 0 is the producer
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // 128·40 + 256·232 = 384·168
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockKeys = 64;  // keys of a dK/dV block

// The tiles of an instance.  DN and DVN are the widths of the products'
// accumulators along D and Dv: the exact head dims of the training path
// (64, 80, 128, 192/128, 256), any other head dim padded up to the next
// instance.  Tiles in shared memory hold ceil(DN / 64) and ceil(DVN / 64)
// swizzled panels; columns past D or Dv are zeros.
template <int DN, int DVN>
struct Cfg {
  static constexpr int kDN = DN, kDVN = DVN;
  static constexpr int kQkPanels = (DN + kPanel - 1) / kPanel;
  static constexpr int kVPanels = (DVN + kPanel - 1) / kPanel;
  // dQ: 64 query rows a consumer, 128 a block; K/V tiles of Bc keys.  A
  // consumer thread holds dQ (DN/2 floats) and a tile's S and dP (Bc/2
  // each): Bc = 32 at DN = 256 keeps that near 160.
  static constexpr int kBlockQ = 64 * kConsumers;
  static constexpr int kBc = DN / 2 <= 96 ? 64 : 32;
  static constexpr int kRowPanel = kBlockQ * 128;  // bytes of a Q or dO panel
  static constexpr int kKeyPanel = kBc * 128;      // bytes of a K or V panel
  static constexpr int kQBytes = kQkPanels * kRowPanel;
  static constexpr int kDoBytes = kVPanels * kRowPanel;
  static constexpr int kKBytes = kQkPanels * kKeyPanel;
  static constexpr int kKvStage = kKBytes + kVPanels * kKeyPanel;
  static constexpr int kDqFree = kMaxSmemBytes - 1024 - kQBytes - kDoBytes - 8 * 9;
  static constexpr int kDqStages = kDqFree / kKvStage < 4 ? kDqFree / kKvStage : 4;
  static constexpr int kDqSmem =
      1024 + kQBytes + kDoBytes + kDqStages * kKvStage + 8 * (1 + 2 * kDqStages);
  // dK/dV: 64 keys a block; query tiles of Br rows with their L·log2(e)
  // and Δ.  Where dK and dV together fit a thread (DN/2 + DVN/2 floats)
  // both consumers accumulate both over alternate tiles and add their sums
  // at the end ("share"); else consumer 0 accumulates dK and consumer 1 dV
  // over every tile, each recomputing S ("roles").  Br keeps a thread's
  // accumulators plus the tile's S and dP (Br/2 each) near 160.
  static constexpr bool kRoles = DN + DVN > 256;
  static constexpr int kAcc = kRoles ? (DN > DVN ? DN : DVN) / 2 : (DN + DVN) / 2;
  static constexpr int kBr = kAcc <= 96 ? 64 : 32;
  static constexpr int kKvBytes = (kQkPanels + kVPanels) * kBlockKeys * 128;
  static constexpr int kStagePanel = kBr * 128;  // bytes of a Q or dO panel of a stage
  static constexpr int kStageQ = kQkPanels * kStagePanel;
  static constexpr int kStageRows = kStageQ + kVPanels * kStagePanel;  // then L·log2(e), Δ
  static constexpr int kStageBytes = (kStageRows + 8 * kBr + 1023) / 1024 * 1024;
  static constexpr int kDkvFree = kMaxSmemBytes - 1024 - kKvBytes - 8 * 9;
  static constexpr int kDkvStages = kDkvFree / kStageBytes < 4 ? kDkvFree / kStageBytes : 4;
  static constexpr int kXBytes = kRoles ? 0 : 128 * kAcc * 4;  // the share's exchange
  static constexpr int kRingBytes =
      kDkvStages * kStageBytes > kXBytes ? kDkvStages * kStageBytes : kXBytes;
  static constexpr int kDkvSmem = 1024 + kKvBytes + kRingBytes + 8 * (1 + 2 * kDkvStages);
  static_assert(kDqStages >= 2 && kDkvStages >= 2, "fewer than two stages fit");
  static_assert(kDqSmem <= kMaxSmemBytes && kDkvSmem <= kMaxSmemBytes, "tiles do not fit");
};

struct Params {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  bf16 *dq, *dk, *dv;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  int n_heads, group, sq, sk, d, dv_dim, causal, window;
  int use_tma;                     // else the producer warpgroup loads the tiles itself
  int dq_pairs, dk_pairs, dv_pairs;  // the gradient takes aligned bf16x2 stores
  float scale, scale_log2;         // D^-½, and D^-½ · log2(e)
};

__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// Rows r0 and r0 + 8 of a thread's accumulator fragment, columns c0 + 8j
// and c0 + 8j + 1 (c0 = 2·(lane % 4)): acc[4j + 2r + e], scaled, to bf16.
template <int N>
__device__ __forceinline__ void store_rows(bf16* base, long long stride, const float (&acc)[N / 2],
                                           int r0, int n_rows, int cols, float scale, int pairs,
                                           int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    if (col >= cols) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row >= n_rows) continue;
      const float x0 = acc[4 * j + 2 * r] * scale, x1 = acc[4 * j + 2 * r + 1] * scale;
      bf16* dst = base + row * stride + col;
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (col + 1 < cols) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ------------------------------------------------------------------- dQ
// One block per (b·h, 128 query rows), the longest causal tiles first.
template <int DN, int DVN>
__global__ void __launch_bounds__(kThreads, 1)
    dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
              const Params p) {
  using C = Cfg<DN, DVN>;
  constexpr int kBc = C::kBc, kStages = C::kDqStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* do_s = q_s + C::kQBytes;
  uint8_t* kv_s = do_s + C::kDoBytes;  // stage s: K panels, then V panels
  uint64_t* q_full = reinterpret_cast<uint64_t*>(kv_s + kStages * C::kKvStage);
  uint64_t* full = q_full + 1;       // [kStages]: the stage has arrived
  uint64_t* empty = full + kStages;  // [kStages]: every consumer warp is done with it

  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kBlockQ;
  const int bh = blockIdx.x, b = bh / p.n_heads, h = bh % p.n_heads, hk = h / p.group;
  const int qk_panels = (p.d + kPanel - 1) / kPanel, v_panels = (p.dv_dim + kPanel - 1) / kPanel;
  int n_kt = (p.sk + kBc - 1) / kBc;
  if (p.causal) n_kt = min(n_kt, (min(q0 + C::kBlockQ, p.sq) - 1) / kBc + 1);
  // tiles kt0 .. n_kt − 1 hold the block's keys (kt0: the first with a key
  // above row q0's window); tile t of the loops holds keys from (kt0 + t)·Bc
  const int kt0 = p.window > 0 ? max(0, q0 - p.window + 1) / kBc : 0;
  const int n_t = n_kt - kt0;

  // panels wholly past D or Dv are never loaded: zero columns, once
  zero_smem<kThreads>(q_s + qk_panels * C::kRowPanel, (C::kQkPanels - qk_panels) * C::kRowPanel);
  zero_smem<kThreads>(do_s + v_panels * C::kRowPanel, (C::kVPanels - v_panels) * C::kRowPanel);
  for (int s = 0; s < kStages; ++s) {
    uint8_t* k_st = kv_s + s * C::kKvStage;
    zero_smem<kThreads>(k_st + qk_panels * C::kKeyPanel, (C::kQkPanels - qk_panels) * C::kKeyPanel);
    zero_smem<kThreads>(k_st + C::kKBytes + v_panels * C::kKeyPanel,
                        (C::kVPanels - v_panels) * C::kKeyPanel);
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
        mbar_expect_tx(q_full, (qk_panels + v_panels) * C::kRowPanel);
        for (int pn = 0; pn < qk_panels; ++pn) {
          tma_load(q_s + pn * C::kRowPanel, &tq, q_full, pn * kPanel, q0, h, b);
        }
        for (int pn = 0; pn < v_panels; ++pn) {
          tma_load(do_s + pn * C::kRowPanel, &tdo, q_full, pn * kPanel, q0, h, b);
        }
        for (int t = 0; t < n_t; ++t) {
          const int s = t % kStages, row = (kt0 + t) * kBc;
          if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
          uint8_t* k_st = kv_s + s * C::kKvStage;
          mbar_expect_tx(&full[s], (qk_panels + v_panels) * C::kKeyPanel);
          for (int pn = 0; pn < qk_panels; ++pn) {
            tma_load(k_st + pn * C::kKeyPanel, &tk, &full[s], pn * kPanel, row, hk, b);
          }
          for (int pn = 0; pn < v_panels; ++pn) {
            tma_load(k_st + C::kKBytes + pn * C::kKeyPanel, &tv, &full[s], pn * kPanel, row, hk,
                     b);
          }
        }
      }
    } else {
      load_tile(q_s, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, q0, p.sq, p.d, C::kBlockQ, qk_panels,
                tid);
      load_tile(do_s, p.dout + b * p.dos.b + h * p.dos.h, p.dos.s, q0, p.sq, p.dv_dim,
                C::kBlockQ, v_panels, tid);
      publish(q_full, tid);
      const bf16* kb = p.k + b * p.ks.b + hk * p.ks.h;
      const bf16* vb = p.v + b * p.vs.b + hk * p.vs.h;
      for (int t = 0; t < n_t; ++t) {
        const int s = t % kStages, row = (kt0 + t) * kBc;
        if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
        uint8_t* k_st = kv_s + s * C::kKvStage;
        load_tile(k_st, kb, p.ks.s, row, p.sk, p.d, kBc, qk_panels, tid);
        load_tile(k_st + C::kKBytes, vb, p.vs.s, row, p.sk, p.dv_dim, kBc, v_panels, tid);
        publish(&full[s], tid);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1, warp = tid / 32, lane = tid % 32;
    const int row_base = q0 + 64 * cw;
    const int r0 = row_base + 16 * warp + lane / 4;  // this thread's rows: r0 and r0 + 8
    const long long rows = static_cast<long long>(bh) * p.sq;

    // Δ = rowsum(dO ∘ O) of the warp's 16 rows (written out for the dK/dV
    // kernel) while the tiles arrive, and L·log2(e) of the thread's rows
    // (+inf past Sq, so that their P is 0)
    float dl[2] = {0.f, 0.f}, lb[2];
    {
      const bf16* ob = p.o + b * p.os.b + h * p.os.h;
      const bf16* dob = p.dout + b * p.dos.b + h * p.dos.h;
      // every row's loads issued before the first sum (a lane's columns:
      // lane + 32·c), then one warp sum a row
      float part[16];
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int row = row_base + 16 * warp + rr;
        part[rr] = 0.f;
#pragma unroll
        for (int c = lane; c < DVN; c += 32) {
          if (row < p.sq && c < p.dv_dim) {
            part[rr] = fmaf(__bfloat162float(dob[row * p.dos.s + c]),
                            __bfloat162float(ob[row * p.os.s + c]), part[rr]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 16; ++rr) {
        const int row = row_base + 16 * warp + rr;
        const float x = warp_sum(part[rr]);
        if (rr == lane / 4) dl[0] = x;
        if (rr == lane / 4 + 8) dl[1] = x;
        if (lane == 0 && row < p.sq) p.delta[rows + row] = x;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        lb[r] = row < p.sq ? p.lse[rows + row] * kLog2e : INFINITY;
      }
    }

    // Both consumers compute all n_t tiles of the block (a tile past a
    // warpgroup's causal rows or below its window is masked whole and adds
    // 0; a warpgroup wholly past Sq computes on zero rows and stores
    // nothing), so no wgmma sits in a data-dependent branch.
    const uint8_t* q_w = q_s + cw * 64 * 128;
    const uint8_t* do_w = do_s + cw * 64 * 128;
    float dq[DN / 2], sc[kBc / 2], dp[kBc / 2];
    uint32_t pa[kBc / 16][4];  // a tile's dS, bf16 pairs as wgmma's A operand
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);
    for (int t = 0; t < n_t; ++t) {
      const int s = t % kStages;
      const uint8_t* k_st = kv_s + s * C::kKvStage;
      const uint8_t* v_st = k_st + C::kKBytes;
      mbar_wait(&full[s], (t / kStages) & 1);
      // S = Q·Kᵀ and dP = dO·Vᵀ, 16 columns of D or Dv a step
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DN / 16; ++ks) {
        const int pn = ks / 4, off = (ks % 4) * 32;
        mma_ss<kBc>(sc, desc(q_w + pn * C::kRowPanel + off, 16, 1024),
                    desc(k_st + pn * C::kKeyPanel + off, 16, 1024), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < DVN / 16; ++ks) {
        const int pn = ks / 4, off = (ks % 4) * 32;
        mma_ss<kBc>(dp, desc(do_w + pn * C::kRowPanel + off, 16, 1024),
                    desc(v_st + pn * C::kKeyPanel + off, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);
      // sc[4j + e] is (row r0 + 8·(e / 2), key k0 + 8j + 2·(lane % 4) + e % 2)
      const int k0 = (kt0 + t) * kBc;
      if (k0 + kBc > p.sk || (p.causal && k0 + kBc - 1 > row_base) ||
          (p.window > 0 && k0 <= row_base + 63 - p.window)) {
#pragma unroll
        for (int j = 0; j < kBc / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int row = r0 + 8 * (e >> 1);
            if (key >= p.sk || (p.causal && key > row) ||
                (p.window > 0 && key <= row - p.window)) {
              sc[4 * j + e] = -INFINITY;
            }
          }
        }
      }
      // P = 2^(S·scale·log2(e) − L·log2(e)), dS = P ∘ (dP − Δ), to bf16
#pragma unroll
      for (int j = 0; j < kBc / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          ds[e] = ex2(fmaf(sc[4 * j + e], p.scale_log2, -lb[r])) * (dp[4 * j + e] - dl[r]);
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS·K, 16 keys a step, K read MN-major (never transposed)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBc / 16; ++kk) {
        mma_rs<DN>(dq, pa[kk], desc(k_st + kk * 16 * 128, C::kKeyPanel, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      release(&empty[s], lane);
    }
    if (row_base >= p.sq) return;
    store_rows<DN>(p.dq + b * p.dqs.b + h * p.dqs.h, p.dqs.s, dq, r0, p.sq, p.d, p.scale,
                   p.dq_pairs, lane);
  }
}

// ---------------------------------------------------------------- dK, dV
// A consumer's walk over the block's tiles: every tile ("roles": kDoK or
// kDoV alone), or every other one from its own index ("share": both, the
// two sums added at the end in a fixed order).  Rows of its fragments are
// the block's keys, columns a tile's query rows.
template <class C, bool kDoK, bool kDoV>
__device__ __forceinline__ void dkv_consume(const Params& p, const uint8_t* k_s,
                                            const uint8_t* v_s, uint8_t* ring, uint64_t* full,
                                            uint64_t* empty, int b, int hk, int k0, int i_lo,
                                            int per_head, int n_t, int cw) {
  constexpr int kBr = C::kBr, kStages = C::kDkvStages;
  constexpr int DN = C::kDN, DVN = C::kDVN;
  constexpr bool kShare = kDoK && kDoV;
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int key_r0 = k0 + 16 * warp + lane / 4;  // this thread's keys: key_r0 and key_r0 + 8
  float dk[kDoK ? DN / 2 : 1], dv[kDoV ? DVN / 2 : 1];
  float st[kBr / 2], dpt[kDoK ? kBr / 2 : 1];
  uint32_t pp[kBr / 16][4], pd[kBr / 16][4];  // Pᵀ and dSᵀ as wgmma's A operand
#pragma unroll
  for (int i = 0; i < (kDoK ? DN / 2 : 1); ++i) dk[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDoV ? DVN / 2 : 1); ++i) dv[i] = 0.f;

  for (int t = kShare ? cw : 0; t < n_t; t += kShare ? 2 : 1) {
    const int s = t % kStages;
    const uint8_t* q_st = ring + s * C::kStageBytes;
    const uint8_t* do_st = q_st + C::kStageQ;
    const float* lb_s = reinterpret_cast<const float*>(q_st + C::kStageRows);
    const float* dl_s = lb_s + kBr;
    const int i0 = i_lo + (t % per_head) * kBr;
    mbar_wait(&full[s], (t / kStages) & 1);
    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DN / 16; ++ks) {
      const int pn = ks / 4, off = (ks % 4) * 32;
      mma_ss<kBr>(st, desc(k_s + pn * kBlockKeys * 128 + off, 16, 1024),
                  desc(q_st + pn * C::kStagePanel + off, 16, 1024), ks > 0);
    }
    if constexpr (kDoK) {
#pragma unroll
      for (int ks = 0; ks < DVN / 16; ++ks) {
        const int pn = ks / 4, off = (ks % 4) * 32;
        mma_ss<kBr>(dpt, desc(v_s + pn * kBlockKeys * 128 + off, 16, 1024),
                    desc(do_st + pn * C::kStagePanel + off, 16, 1024), ks > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    if constexpr (kDoK) fence_regs(dpt);
    // st[4j + e] is (key key_r0 + 8·(e / 2), row i0 + 8j + 2·(lane % 4) + e % 2);
    // rows past Sq carry L·log2(e) = +inf, so their P is 0 unmasked
    if (k0 + kBlockKeys > p.sk || (p.causal && i0 < k0 + kBlockKeys - 1) ||
        (p.window > 0 && i0 + kBr - 1 - p.window >= k0)) {
#pragma unroll
      for (int j = 0; j < kBr / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_r0 + 8 * (e >> 1);
          const int row = i0 + 8 * j + 2 * (lane % 4) + (e & 1);
          if (key >= p.sk || (p.causal && key > row) || (p.window > 0 && key <= row - p.window)) {
            st[4 * j + e] = -INFINITY;
          }
        }
      }
    }
    // Pᵀ and dSᵀ = Pᵀ ∘ (dPᵀ − Δ), to bf16
#pragma unroll
    for (int j = 0; j < kBr / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lb_s + c);
      const float2 d2 = *reinterpret_cast<const float2*>(dl_s + c);
      float pv[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = ex2(fmaf(st[4 * j + e], p.scale_log2, -((e & 1) ? l2.y : l2.x)));
        if constexpr (kDoK) ds[e] = pv[e] * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      if constexpr (kDoV) {
        pp[j / 2][(j % 2) * 2] = pack_bf16(pv[0], pv[1]);
        pp[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      }
      if constexpr (kDoK) {
        pd[j / 2][(j % 2) * 2] = pack_bf16(ds[0], ds[1]);
        pd[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
    }
    // dV += Pᵀ·dO and dK += dSᵀ·Q, 16 query rows a step, dO and Q read MN-major
    wgmma_fence();
    if constexpr (kDoV) {
#pragma unroll
      for (int kk = 0; kk < kBr / 16; ++kk) {
        mma_rs<DVN>(dv, pp[kk], desc(do_st + kk * 16 * 128, C::kStagePanel, 1024), 1);
      }
    }
    if constexpr (kDoK) {
#pragma unroll
      for (int kk = 0; kk < kBr / 16; ++kk) {
        mma_rs<DN>(dk, pd[kk], desc(q_st + kk * 16 * 128, C::kStagePanel, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (kDoV) fence_regs(dv);
    if constexpr (kDoK) fence_regs(dk);
    release(&empty[s], lane);
  }

  if constexpr (kShare) {
    // consumer 1's sums through shared memory (the ring, whose tiles have
    // all landed and been read), added to consumer 0's in that order
    float* x = reinterpret_cast<float*>(ring);
    asm volatile("bar.sync 2, 256;" ::: "memory");
    if (cw == 1) {
#pragma unroll
      for (int i = 0; i < DN / 2; ++i) x[i * 128 + tid] = dk[i];
#pragma unroll
      for (int i = 0; i < DVN / 2; ++i) x[(DN / 2 + i) * 128 + tid] = dv[i];
    }
    asm volatile("bar.sync 2, 256;" ::: "memory");
    if (cw == 1) return;
#pragma unroll
    for (int i = 0; i < DN / 2; ++i) dk[i] += x[i * 128 + tid];
#pragma unroll
    for (int i = 0; i < DVN / 2; ++i) dv[i] += x[(DN / 2 + i) * 128 + tid];
  }
  if constexpr (kDoK) {
    store_rows<DN>(p.dk + b * p.dks.b + hk * p.dks.h, p.dks.s, dk, key_r0, p.sk, p.d, p.scale,
                   p.dk_pairs, lane);
  }
  if constexpr (kDoV) {
    store_rows<DVN>(p.dv + b * p.dvs.b + hk * p.dvs.h, p.dvs.s, dv, key_r0, p.sk, p.dv_dim, 1.f,
                    p.dv_pairs, lane);
  }
}

// One block per (b·hkv, 64 keys), the keys with the most causal query rows
// first.  It walks the query heads of its KV head in order and, for each,
// the query tiles whose rows see its keys, so a GQA group's sum stays in
// the block.
template <int DN, int DVN>
__global__ void __launch_bounds__(kThreads, 1)
    dkv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
               const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
               const Params p) {
  using C = Cfg<DN, DVN>;
  constexpr int kBr = C::kBr, kStages = C::kDkvStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* v_s = k_s + C::kQkPanels * kBlockKeys * 128;
  uint8_t* ring = v_s + C::kVPanels * kBlockKeys * 128;  // stage s: Q, dO, L·log2(e), Δ
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + C::kRingBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int n_kv = p.n_heads / p.group;
  const int b = blockIdx.x / n_kv, hk = blockIdx.x % n_kv;
  const int k0 = blockIdx.y * kBlockKeys;
  const int qk_panels = (p.d + kPanel - 1) / kPanel, v_panels = (p.dv_dim + kPanel - 1) / kPanel;
  // the query rows that see a key of [k0, k0 + 64): causal from k0 (a
  // multiple of Br); a window up to the last key + W − 1
  const int k_last = min(k0 + kBlockKeys, p.sk) - 1;
  const int i_lo = p.causal ? k0 : 0;
  const int i_hi = p.window > 0 ? min(p.sq, k_last + p.window) : p.sq;  // exclusive
  const int per_head = i_hi > i_lo ? (i_hi - i_lo + kBr - 1) / kBr : 0;
  const int n_t = p.group * per_head;  // tile t: head hk·group + t / per_head

  zero_smem<kThreads>(k_s + qk_panels * kBlockKeys * 128,
                      (C::kQkPanels - qk_panels) * kBlockKeys * 128);
  zero_smem<kThreads>(v_s + v_panels * kBlockKeys * 128,
                      (C::kVPanels - v_panels) * kBlockKeys * 128);
  for (int s = 0; s < kStages; ++s) {
    uint8_t* st = ring + s * C::kStageBytes;
    zero_smem<kThreads>(st + qk_panels * C::kStagePanel,
                        (C::kQkPanels - qk_panels) * C::kStagePanel);
    zero_smem<kThreads>(st + C::kStageQ + v_panels * C::kStagePanel,
                        (C::kVPanels - v_panels) * C::kStagePanel);
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], C::kRoles ? 4 * kConsumers : 4);  // share: one consumer a tile
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
        mbar_expect_tx(kv_full, (qk_panels + v_panels) * kBlockKeys * 128);
        for (int pn = 0; pn < qk_panels; ++pn) {
          tma_load(k_s + pn * kBlockKeys * 128, &tk, kv_full, pn * kPanel, k0, hk, b);
        }
        for (int pn = 0; pn < v_panels; ++pn) {
          tma_load(v_s + pn * kBlockKeys * 128, &tv, kv_full, pn * kPanel, k0, hk, b);
        }
      }
    } else {
      load_tile(k_s, p.k + b * p.ks.b + hk * p.ks.h, p.ks.s, k0, p.sk, p.d, kBlockKeys, qk_panels,
                tid);
      load_tile(v_s, p.v + b * p.vs.b + hk * p.vs.h, p.vs.s, k0, p.sk, p.dv_dim, kBlockKeys,
                v_panels, tid);
      publish(kv_full, tid);
    }
    for (int t = 0; t < n_t; ++t) {
      const int s = t % kStages;
      const int h = hk * p.group + t / per_head, i0 = i_lo + (t % per_head) * kBr;
      uint8_t* st = ring + s * C::kStageBytes;
      float* lb_s = reinterpret_cast<float*>(st + C::kStageRows);
      if (t >= kStages) mbar_wait(&empty[s], (t / kStages - 1) & 1);
      if (tid < kBr) {
        const int i = i0 + tid;
        const long long at = (static_cast<long long>(b) * p.n_heads + h) * p.sq + i;
        lb_s[tid] = i < p.sq ? p.lse[at] * kLog2e : INFINITY;
        lb_s[kBr + tid] = i < p.sq ? p.delta[at] : 0.f;
      }
      if (p.use_tma) {
        asm volatile("bar.sync 1, 128;" ::: "memory");  // L and Δ stored before the arrival
        if (tid == 0) {
          mbar_expect_tx(&full[s], (qk_panels + v_panels) * C::kStagePanel);
          for (int pn = 0; pn < qk_panels; ++pn) {
            tma_load(st + pn * C::kStagePanel, &tq, &full[s], pn * kPanel, i0, h, b);
          }
          for (int pn = 0; pn < v_panels; ++pn) {
            tma_load(st + C::kStageQ + pn * C::kStagePanel, &tdo, &full[s], pn * kPanel, i0, h,
                     b);
          }
        }
      } else {
        load_tile(st, p.q + b * p.qs.b + h * p.qs.h, p.qs.s, i0, p.sq, p.d, kBr, qk_panels, tid);
        load_tile(st + C::kStageQ, p.dout + b * p.dos.b + h * p.dos.h, p.dos.s, i0, p.sq,
                  p.dv_dim, kBr, v_panels, tid);
        publish(&full[s], tid);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    mbar_wait(kv_full, 0);
    if constexpr (C::kRoles) {
      if (cw == 0) {
        dkv_consume<C, true, false>(p, k_s, v_s, ring, full, empty, b, hk, k0, i_lo, per_head,
                                    n_t, cw);
      } else {
        dkv_consume<C, false, true>(p, k_s, v_s, ring, full, empty, b, hk, k0, i_lo, per_head,
                                    n_t, cw);
      }
    } else {
      dkv_consume<C, true, true>(p, k_s, v_s, ring, full, empty, b, hk, k0, i_lo, per_head, n_t,
                                 cw);
    }
  }
}

// ------------------------------------------------------------ launchers
// The four views TMA reads (q, dO: boxes of q_rows; k, v: kv_rows) as
// tensor maps, or `tma` false where one breaks TMA's rules.
struct Maps {
  CUtensorMap q, dout, k, v;
  bool tma;
};

cudaError_t make_maps(const Problem& a, int q_rows, int kv_rows, Maps* m) {
  const int hkv = a.n_heads / a.group;
  const TmaView vq = tma_view(a.q, a.d, a.sq, a.n_heads, a.batch, a.qs);
  const TmaView vdo = tma_view(a.dout, a.dv_dim, a.sq, a.n_heads, a.batch, a.dos);
  const TmaView vk = tma_view(a.k, a.d, a.sk, hkv, a.batch, a.ks);
  const TmaView vv = tma_view(a.v, a.dv_dim, a.sk, hkv, a.batch, a.vs);
  *m = Maps{};
  m->tma = vq.ok && vdo.ok && vk.ok && vv.ok;
  if (!m->tma) return cudaSuccess;
  cudaError_t err = encode(&m->q, a.q, vq, q_rows);
  if (err == cudaSuccess) err = encode(&m->dout, a.dout, vdo, q_rows);
  if (err == cudaSuccess) err = encode(&m->k, a.k, vk, kv_rows);
  if (err == cudaSuccess) err = encode(&m->v, a.v, vv, kv_rows);
  return err;
}

bool pairs(const void* base, Strides s, int cols) {
  return cols % 2 == 0 && s.s % 2 == 0 && s.h % 2 == 0 && s.b % 2 == 0 &&
         reinterpret_cast<uintptr_t>(base) % 4 == 0;
}

Params params(const Problem& a, bool tma) {
  Params p;
  p.q = static_cast<const bf16*>(a.q);
  p.k = static_cast<const bf16*>(a.k);
  p.v = static_cast<const bf16*>(a.v);
  p.o = static_cast<const bf16*>(a.o);
  p.dout = static_cast<const bf16*>(a.dout);
  p.lse = a.lse;
  p.delta = a.delta;
  p.dq = static_cast<bf16*>(a.dq);
  p.dk = static_cast<bf16*>(a.dk);
  p.dv = static_cast<bf16*>(a.dv);
  p.qs = a.qs, p.ks = a.ks, p.vs = a.vs, p.os = a.os, p.dos = a.dos;
  p.dqs = a.dqs, p.dks = a.dks, p.dvs = a.dvs;
  p.n_heads = a.n_heads, p.group = a.group, p.sq = a.sq, p.sk = a.sk;
  p.d = a.d, p.dv_dim = a.dv_dim, p.causal = a.causal, p.window = a.window;
  p.use_tma = tma;
  p.dq_pairs = pairs(a.dq, a.dqs, a.d);
  p.dk_pairs = pairs(a.dk, a.dks, a.d);
  p.dv_pairs = pairs(a.dv, a.dvs, a.dv_dim);
  p.scale = a.scale;
  p.scale_log2 = a.scale * 1.4426950408889634f;
  return p;
}

template <int DN, int DVN>
cudaError_t launch_dq(const Problem& a, int* path) {
  using C = Cfg<DN, DVN>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(dq_kernel<DN, DVN>, configured, a.device);
  if (err != cudaSuccess) return err;
  Maps m;
  err = make_maps(a, C::kBlockQ, C::kBc, &m);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * a.n_heads, (a.sq + C::kBlockQ - 1) / C::kBlockQ);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  dq_kernel<DN, DVN><<<grid, kThreads, C::kDqSmem, a.stream>>>(m.q, m.dout, m.k, m.v,
                                                                params(a, m.tma));
  *path = m.tma ? kPathTma : kPathLoads;
  return cudaGetLastError();
}

template <int DN, int DVN>
cudaError_t launch_dkv(const Problem& a, int* path) {
  using C = Cfg<DN, DVN>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = allow_smem(dkv_kernel<DN, DVN>, configured, a.device);
  if (err != cudaSuccess) return err;
  Maps m;
  err = make_maps(a, C::kBr, kBlockKeys, &m);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.batch * (a.n_heads / a.group), (a.sk + kBlockKeys - 1) / kBlockKeys);
  if (grid.y > kMaxGridY) return cudaErrorInvalidValue;
  dkv_kernel<DN, DVN><<<grid, kThreads, C::kDkvSmem, a.stream>>>(m.q, m.dout, m.k, m.v,
                                                                  params(a, m.tma));
  *path = m.tma ? kPathTma : kPathLoads;
  return cudaGetLastError();
}

// The instance of (D, Dv): the first of (64, 64), (80, 80), (128, 128),
// (192, 128), (256, 256) that holds both (kernels/flash_attention/
// emulation.py's bwd_tiles mirrors this table).
template <bool kDq>
cudaError_t dispatch(const Problem& a, int* path) {
  const int d = a.d, dv = a.dv_dim;
  if (d <= 64 && dv <= 64) return kDq ? launch_dq<64, 64>(a, path) : launch_dkv<64, 64>(a, path);
  if (d <= 80 && dv <= 80) return kDq ? launch_dq<80, 80>(a, path) : launch_dkv<80, 80>(a, path);
  if (d <= 128 && dv <= 128) {
    return kDq ? launch_dq<128, 128>(a, path) : launch_dkv<128, 128>(a, path);
  }
  if (d <= 192 && dv <= 128) {
    return kDq ? launch_dq<192, 128>(a, path) : launch_dkv<192, 128>(a, path);
  }
  return kDq ? launch_dq<256, 256>(a, path) : launch_dkv<256, 256>(a, path);
}

}  // namespace sm90

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
// *path tells which kernel and load path a successful launch took:
// kPathSimt, kPathTma or kPathLoads.
#define FLASH_BWD_ARGS                                                                     \
  const void *q, const void *k, const void *v, const void *o, const void *dout,            \
      const float *lse, float *delta, void *dq, void *dk, void *dv, const long long *strides, \
      int batch, int n_heads, int n_kv_heads, int sq, int sk, int d, int dv_dim, int causal, \
      int window, float scale, int dtype, int device, void *stream, int *path

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
  *path = kPathSimt;
  const cudaError_t err = dtype == 0   ? by_width<DQ, float>(a, d)
                          : dtype == 1 ? sm90::dispatch<true>(a, path)
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
  *path = kPathSimt;
  const cudaError_t err = dtype == 0   ? by_width<DKV, float>(a, d > dv_dim ? d : dv_dim)
                          : dtype == 1 ? sm90::dispatch<false>(a, path)
                                       : cudaErrorInvalidValue;
  return static_cast<int>(err);
}
