// ensemble_sum: per-row sum of leaf values over a tensorized tree ensemble.
//
// Replaces the Pallas kernel repro/kernels/tree_qmc/tree_qmc.py
// (ensemble_sum, body _kernel): node tables (T, M) i32 feature / f32
// threshold / i32 left / i32 right / f32 value, x (m, F) f32 -> (m,) f32.
// Traversal is `depth` gather rounds per tree,
//     idx <- x[row, feature[idx]] <= threshold[idx] ? left[idx] : right[idx],
// with leaves looping to themselves.  Each row's leaves are added in tree
// order t = 0..T-1 with __fadd_rn, starting from 0, with no atomics: two
// launches, and both paths, give bitwise-equal sums, equal to the plain
// version's (the serving loop's plans depend on it).
//
// Two paths, chosen by the wrapper (kernels/tree_qmc/tree_qmc.py):
//
// smem (`smem_kernel`): the work is spread over (row, tree) walks, 152,680
// of them at m = 3817, T = 40.  The trees are cut into C <= 8 groups of G
// consecutive trees, and a thread-block cluster of C blocks takes a tile of
// R rows: block c stages group c's five node tables in its shared memory
// once, and the x tile of each row tile it takes, by bulk asynchronous
// copies on mbarriers, so every level of a walk reads shared memory rather
// than gathering from L2.  256 threads walk the tile's R·G (row, tree)
// pairs, 256/R trees of a row side by side and four walks interleaved in
// each thread.  Each block writes its leaves to its own shared memory;
// after a cluster barrier every block gathers its R/C rows' leaves of all
// T trees from the cluster's blocks through distributed shared memory (many
// loads in flight), a second barrier frees the leaves, and each row is
// folded in tree order from the local copy (a lone block folds its own
// leaves).  A cluster loops over row tiles when m would need more than
// about two blocks an SM, so the tables are staged once.
//
// global (`global_kernel`, the earlier design): one thread a row walks all
// trees, four at a time, its gathers through the read-only cache.  It takes
// any forest, and the wrapper sends it those whose groups cannot fit shared
// memory in a cluster of 8 (one tree deeper than about 13 levels, or too
// many deep trees).
//
// Bound.  The kernel must read x and the tables and write the sums (about
// 0.56 MB at m = 3817 for the 40 x 511 forest): ~0.17 us at 3.35 TB/s.  The
// work is m·T·depth = 1.22e6 dependent node visits, each two shared-memory
// round trips on the smem path (L2 round trips on the global one), so
// latency and shared-memory bandwidth, not HBM bytes, set the time.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "async_copy.cuh"
#include "device_guard.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kInterleave = 4;
constexpr int kMaxDevices = 64;
constexpr int kMaxSmemBytes = 232448;  // what one block of an H100 may use
constexpr int kMaxCluster = 8;

// ------------------------------------------------------------------ global
__global__ void __launch_bounds__(128)
global_kernel(const int* __restrict__ feature, const float* __restrict__ threshold,
              const int* __restrict__ left, const int* __restrict__ right,
              const float* __restrict__ value, const float* __restrict__ x,
              float* __restrict__ out, int m, int n_trees, int n_nodes, int n_feat, int depth) {
  const int row = blockIdx.x * 128 + threadIdx.x;
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

// -------------------------------------------------------------------- smem
constexpr int kTables = 5;  // feature, threshold, left, right, value

// Shared-memory layout of a block (every block of a launch has the same):
// two mbarriers (tables, x tile), the five node tables of group·M words
// each (plus up to 3 words in front, so that the 16-byte-aligned middle of
// the run can be bulk copied), the x tile (R·F words, the same), the
// leaves (R rows of G words, an odd stride so that a warp's rows fall in
// distinct banks) and, in a cluster, the fold buffer (the block's R/C rows
// of all T leaves, tree-major).
struct Layout {
  int table_words, x_words, leaf_stride, fold_rows;
  size_t bytes;
};

__host__ __device__ inline int round4(int w) { return (w + 3) / 4 * 4; }

__host__ __device__ inline Layout layout(int n_trees, int n_nodes, int n_feat, int group,
                                         int rows) {
  const int cluster = (n_trees + group - 1) / group;
  Layout l;
  l.table_words = round4(group * n_nodes + 3);
  l.x_words = round4(rows * n_feat + 3);
  l.leaf_stride = group | 1;
  l.fold_rows = (rows + cluster - 1) / cluster;
  const size_t fold_words = cluster > 1 ? static_cast<size_t>(l.fold_rows) * n_trees : 0;
  l.bytes = 16 + sizeof(int) * (kTables * static_cast<size_t>(l.table_words) + l.x_words +
                                static_cast<size_t>(rows) * l.leaf_stride + fold_words);
  return l;
}

// A run of n words at src, copied to shared memory so that src[i] lands at
// dst[pad + i], pad = (address of src mod 16) / 4: its 16-byte-aligned
// middle by one bulk copy, the up to 3 + 3 words around it by plain loads.
struct Run {
  int pad, head, middle;
};

__device__ __forceinline__ Run run_of(const int* src, int n) {
  Run u;
  u.pad = static_cast<int>((reinterpret_cast<uintptr_t>(src) % 16) / 4);
  u.head = min(n, (4 - u.pad) % 4);
  u.middle = (n - u.head) / 4 * 4;
  return u;
}

__global__ void __launch_bounds__(kThreads)
smem_kernel(const int* __restrict__ feature, const float* __restrict__ threshold,
            const int* __restrict__ left, const int* __restrict__ right,
            const float* __restrict__ value, const float* __restrict__ x,
            float* __restrict__ out, int m, int n_trees, int n_nodes, int n_feat, int depth,
            int group, int rows) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n_groups = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_clusters = gridDim.x / n_groups;
  const int first_cluster = blockIdx.x / n_groups;
  const int tid = threadIdx.x;
  const int t0 = rank * group;
  const int g_n = min(group, n_trees - t0);  // trees of this block's group

  extern __shared__ __align__(16) uint8_t smem_raw[];
  const Layout lay = layout(n_trees, n_nodes, n_feat, group, rows);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* xbar = bar + 1;
  int* tabs = reinterpret_cast<int*>(smem_raw + 16);
  float* x_s = reinterpret_cast<float*>(tabs + kTables * lay.table_words);
  float* leaves = x_s + lay.x_words;                      // [row][tree of the group]
  float* fold_s = leaves + rows * lay.leaf_stride;        // [tree][fold row]

  // the group's five tables, once
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const size_t off = static_cast<size_t>(t0) * n_nodes;
  const int n_words = g_n * n_nodes;
  const int* src[kTables] = {feature + off, reinterpret_cast<const int*>(threshold) + off,
                             left + off, right + off, reinterpret_cast<const int*>(value) + off};
  Run run[kTables];
  uint32_t bytes = 0;
#pragma unroll
  for (int a = 0; a < kTables; ++a) {
    run[a] = run_of(src[a], n_words);
    bytes += run[a].middle * sizeof(int);
  }
  if (tid == 0) {
    mbar_expect_tx(bar, bytes);
#pragma unroll
    for (int a = 0; a < kTables; ++a) {
      int* d = tabs + a * lay.table_words + run[a].pad + run[a].head;
      if (run[a].middle > 0) {
        bulk_load(d, src[a] + run[a].head, run[a].middle * sizeof(int), bar);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < kTables; ++a) {
    int* d = tabs + a * lay.table_words + run[a].pad;
    for (int i = tid; i < n_words - run[a].middle; i += kThreads) {
      const int w = i < run[a].head ? i : i + run[a].middle;
      d[w] = __ldg(src[a] + w);
    }
  }
  const int* f_s = tabs + run[0].pad;
  const float* thr_s = reinterpret_cast<const float*>(tabs + lay.table_words + run[1].pad);
  const int* l_s = tabs + 2 * lay.table_words + run[2].pad;
  const int* r_s = tabs + 3 * lay.table_words + run[3].pad;
  const float* v_s = reinterpret_cast<const float*>(tabs + 4 * lay.table_words + run[4].pad);

  // threads: R rows x S slices; slice s walks trees s, s + S, ... of the group
  const int slices = kThreads / rows;
  const int r = tid % rows, slice = tid / rows;
  const int n_tiles = (m + rows - 1) / rows;
  const int fold_rows = lay.fold_rows;
  bool tables_ready = false;
  for (int tile = first_cluster, it = 0; tile < n_tiles; tile += n_clusters, ++it) {
    const int r0 = tile * rows;
    const int nr = min(rows, m - r0);
    // the x tile, like the tables: its aligned middle by one bulk copy
    const int* xt = reinterpret_cast<const int*>(x) + static_cast<size_t>(r0) * n_feat;
    const Run xrun = run_of(xt, nr * n_feat);
    int* xd = reinterpret_cast<int*>(x_s) + xrun.pad;
    if (tid == 0) {
      mbar_expect_tx(xbar, xrun.middle * sizeof(int));
      if (xrun.middle > 0) {
        bulk_load(xd + xrun.head, xt + xrun.head, xrun.middle * sizeof(int), xbar);
      }
    }
    for (int i = tid; i < nr * n_feat - xrun.middle; i += kThreads) {
      const int w = i < xrun.head ? i : i + xrun.middle;
      xd[w] = __ldg(xt + w);
    }
    if (!tables_ready) {
      mbar_wait(bar, 0);
      tables_ready = true;
    }
    mbar_wait(xbar, it & 1);
    __syncthreads();
    if (r < nr) {
      const float* xr = x_s + xrun.pad + r * n_feat;
      for (int j0 = slice; j0 < g_n; j0 += kInterleave * slices) {
        int idx[kInterleave], base[kInterleave];
#pragma unroll
        for (int u = 0; u < kInterleave; ++u) {
          const int j = min(j0 + u * slices, g_n - 1);  // a repeat past the group is dropped
          base[u] = j * n_nodes;
          idx[u] = 0;
        }
        for (int d = 0; d < depth; ++d) {
#pragma unroll
          for (int u = 0; u < kInterleave; ++u) {
            const int node = base[u] + idx[u];
            const bool go_left = xr[f_s[node]] <= thr_s[node];
            idx[u] = go_left ? l_s[node] : r_s[node];
          }
        }
#pragma unroll
        for (int u = 0; u < kInterleave; ++u) {
          const int j = j0 + u * slices;
          if (j < g_n) leaves[r * lay.leaf_stride + j] = v_s[base[u] + idx[u]];
        }
      }
    }
    cluster.sync();  // every group's leaves of the tile are written
    // this block's share of the tile's rows: all T leaves in tree order
    const float* fold = leaves;
    int fold_stride = 1, row_stride = lay.leaf_stride;
    const int r_first = rank * fold_rows;
    if (n_groups > 1) {
      // gather the rows' leaves from every block of the cluster, many
      // distributed-shared-memory loads in flight, then fold locally
      const int n_fold = fold_rows * n_trees;
      for (int i0 = tid; i0 < n_fold; i0 += 4 * kThreads) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * kThreads;
          const int t = i / fold_rows, fr = r_first + i % fold_rows;
          v[u] = i < n_fold && fr < nr
                     ? cluster.map_shared_rank(leaves, t / group)[fr * lay.leaf_stride + t % group]
                     : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (i0 + u * kThreads < n_fold) fold_s[i0 + u * kThreads] = v[u];
        }
      }
      cluster.sync();  // every block's leaves are read: the next tile may rewrite them
      fold = fold_s;
      fold_stride = fold_rows;
      row_stride = 1;
    }
    const int fr = r_first + tid;
    if (tid < fold_rows && fr < nr) {
      const float* lv = fold + (n_groups > 1 ? tid : fr * row_stride);
      float acc = 0.f;
      for (int c = 0; c < n_groups; ++c) {
        const int gc = min(group, n_trees - c * group);
        const float* lc = lv + (n_groups > 1 ? c * group * fold_stride : 0);
        int j = 0;
        for (; j + 8 <= gc; j += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = lc[(j + u) * fold_stride];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
        }
        for (; j < gc; ++j) acc = __fadd_rn(acc, lc[j * fold_stride]);
      }
      out[r0 + fr] = acc;
    }
    // the x tile, leaves and fold buffer are read before the next tile
    // rewrites them (the x tile by the async proxy)
    fence_proxy_async();
    __syncthreads();
  }
  if (!tables_ready) mbar_wait(bar, 0);  // no bulk copy outlives its block
}

bool smem_configured[kMaxDevices] = {};

}  // namespace

// cluster = 0: the global kernel.  cluster = C in 1..8: the smem kernel
// with groups of `group` trees (C = ceil(T / group)), row tiles of `rows`
// (a divisor of 256) and `clusters` clusters looping over the tiles.
extern "C" int ensemble_sum_launch(const void* feature, const void* threshold,
                                   const void* left, const void* right, const void* value,
                                   const void* x, void* out, int m, int n_trees,
                                   int n_nodes, int n_feat, int depth, int cluster,
                                   int group, int rows, int clusters, int device,
                                   void* stream) {
  if (m < 1 || n_trees < 1 || n_nodes < 1 || n_feat < 1 || depth < 0 ||
      device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const auto strm = static_cast<cudaStream_t>(stream);
  const auto* f = static_cast<const int*>(feature);
  const auto* thr = static_cast<const float*>(threshold);
  const auto* l = static_cast<const int*>(left);
  const auto* r = static_cast<const int*>(right);
  const auto* v = static_cast<const float*>(value);
  const auto* xx = static_cast<const float*>(x);
  auto* o = static_cast<float*>(out);
  if (cluster == 0) {
    global_kernel<<<(m + 127) / 128, 128, 0, strm>>>(f, thr, l, r, v, xx, o, m, n_trees,
                                                   n_nodes, n_feat, depth);
    return static_cast<int>(cudaGetLastError());
  }
  const Layout lay = layout(n_trees, n_nodes, n_feat, group, rows);
  if (cluster > kMaxCluster || group < 1 || (n_trees + group - 1) / group != cluster ||
      rows < 1 || kThreads % rows != 0 || clusters < 1 || lay.bytes > kMaxSmemBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!smem_configured[device]) {
    // raised once per card, at the first launch, so that no attribute call
    // falls inside a CUDA-graph capture (the callers warm up first)
    const cudaError_t err = cudaFuncSetAttribute(
        smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_configured[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = lay.bytes;
  cfg.stream = strm;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, smem_kernel, f, thr, l, r, v, xx, o, m,
                                             n_trees, n_nodes, n_feat, depth, group, rows);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
