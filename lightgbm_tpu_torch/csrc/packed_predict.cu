// The serving path's three kernels over a packed ensemble, for Hopper
// (sm_90a): packed_bin_rows, packed_predict_leaves, packed_predict_values.
//
// Counterparts of lightgbm_tpu/ops/predict.py ``packed_bin_rows`` (:299, a
// vmapped jnp.searchsorted), ``packed_predict_leaves`` (:266, a vmap over
// trees of ``_packed_tree_leaf`` :204, a lax.while_loop over node-index
// vectors) and ``packed_predict_values`` (:276, the leaves, a gather and a
// class-wise sum). They replace no Pallas kernel: the reference leaves the
// serving path to XLA. Their plain versions are the functions of the same
// names in ops/predict.py, equal bit for bit: the binning and the traversal
// are compares, and the values sum each class's trees one f32 add a tree, in
// tree order, exactly as the plain version does (XLA's reduction differs
// from both only by its summation order).
//
// The ensemble is lightgbm_tpu_torch/serve/packed.py's ``PackedTrees``: node
// fields [T, M] (feature, threshold rank, default_left, missing type,
// children with leaves as -(leaf+1), is_cat, and the bitset words' offset and
// count), leaf values [T, L], leaf counts [T], one uint32 bitset pool, and
// per feature the ranks of 0.0 and of -/+kZeroThreshold.
//
// packed_bin_rows: one thread a (row, feature), rows in order, so a warp
// reads consecutive values of a row. A numerical feature's code is the
// number of its f32 bounds below the value with NaN replaced by 0 (a binary
// search over the feature's [Bmax] row, padded with +inf: searchsorted with
// side="left"; -0.0 compares equal to 0.0, and +inf lands past every finite
// bound); a categorical feature's is trunc(clip(x, -2e9, 2e9)). Bound: the
// bytes, N·F·(4 + 4 + 1), the bounds' rows being L1/L2-resident.
//
// Node table: both traversal kernels read the trees from a [T, M, 8] int32
// table the wrapper builds once per ensemble (ops/packed_kernel.py
// ``node_table``): a node's 11 fields packed into two 16-byte words,
// (feature, threshold rank, left, right) and (missing type | default_left
// << 2 | is_cat << 3, bitset offset, bitset words, 0), so a block stages a
// tree with two coalesced 16-byte loads a node, issued four at a time
// before any store, instead of nine scattered loads a node.
//
// packed_predict_leaves: a block is (tile of 256 rows, tree); it stages the
// tree's M nodes in shared memory, 32 bytes a node, 8 KB at 255 leaves, then
// one thread walks one row from the root to its leaf and stores it at
// out[t, r], coalesced along N. A level reads the
// node from shared memory and the row's code and NaN flag of the node's
// feature from global memory: a row's codes are gathered one feature at a
// time, and at F = 28 a row is 112 + 28 bytes, two to five 32-byte sectors,
// so after its first levels a row's walk reads from L1. What bounds it:
// bytes, the codes and NaN flags of every row read once for each of the T
// trees unless L1/L2 keep them (N·F·5 bytes once, N·T·4 written); in
// practice the latency of the walk's dependent loads, hidden only by the
// rows in flight. Categorical nodes read their bitset word from global memory.
//
// packed_predict_values: a block owns a tile of 32 rows and loops over the
// trees in order, kTrees at a time: its 256 threads stage the round's trees
// (contiguous in the node table) in shared memory (kTrees x M x 32 bytes,
// 64 KB at 255 leaves), warp w walks
// tree i0 + w for the tile's 32 rows (a lane a row) and puts the leaf's f32
// value in shared memory, then warp 0 adds the round's values into each
// row's class accumulator (tree i into class i % K) one tree after another,
// so each class sums its trees in tree order. ``average_output`` divides by
// the iteration count at the end (an IEEE division, as the plain version's).
// Bound: bytes, the codes and NaN flags read once (N·F·5) and [K, N] f32
// written; the traversal is N·T walks.
//
// Built with --fmad=false like every kernel of the port (there is no
// multiply-add here to contract; the flag keeps one build line).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMissingZero = 1, kMissingNan = 2;  // ops/split.py MISSING_*
constexpr int kTrees = kThreads / 32;  // packed_predict_values: a warp a tree of a round
constexpr int kTileRows = 32;  // packed_predict_values: a lane a row

struct Ensemble {
  const int4* table;  // [T, M, 2] int4: the node table
  const int* num_leaves;
  const uint32_t* cat_words;
  const int* rank0;
  const int* zero_lo;
  const int* zero_hi;
  int T, M;
};

constexpr int kStageBatch = 4;  // 16-byte loads in flight a thread before its stores

// Copy ``count`` (> 0) int4 from the node table into shared memory, every
// thread of the block taking a strided share, kStageBatch loads issued before
// the stores (a load past the end rereads the last word, whose store is skipped).
__device__ __forceinline__ void stage(const int4* __restrict__ src, int4* dst, int count) {
  for (int base = threadIdx.x; base < count; base += kStageBatch * kThreads) {
    int4 v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) v[u] = __ldg(src + min(base + u * kThreads, count - 1));
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = base + u * kThreads;
      if (i < count) dst[i] = v[u];
    }
  }
}

// _packed_tree_leaf's decision at one node for one row (lightgbm_tpu/ops/predict.py:225-249).
__device__ __forceinline__ bool go_left(const int4 a, const int4 b, const int* __restrict__ codes,
                                        const unsigned char* __restrict__ isnan,
                                        const Ensemble& e) {
  const int f = a.x;
  const int c = codes[f];
  const bool nan = isnan[f] != 0;
  const int m = b.x & 3;
  if ((b.x >> 3) & 1) {  // categorical
    const int nw = b.z;
    if (nw == 0) return !nan && c == a.y;  // legacy single-category equality
    const int iv = nan ? 0 : c;
    if (iv < 0 || (iv >> 5) >= nw || (nan && m == kMissingNan)) return false;
    return (e.cat_words[b.y + (iv >> 5)] >> (iv & 31)) & 1u;
  }
  // numerical: NaN is 0.0 (rank0) unless the missing type is NaN; then the
  // kZeroThreshold window of missing-zero, NaN's default, or the rank compare
  const int eff = (nan && m != kMissingNan) ? e.rank0[f] : c;
  const bool in_band = eff > e.zero_lo[f] && eff <= e.zero_hi[f];
  if ((m == kMissingZero && in_band) || (m == kMissingNan && nan)) return (b.x >> 2) & 1;
  return eff <= a.y;
}

__device__ __forceinline__ int walk(const int4* nodes, int num_leaves, const int* codes,
                                    const unsigned char* isnan, const Ensemble& e) {
  int node = num_leaves > 1 ? 0 : -1;  // a stump: every row at leaf 0
  while (node >= 0) {
    const int4 a = nodes[2 * node];
    node = go_left(a, nodes[2 * node + 1], codes, isnan, e) ? a.z : a.w;
  }
  return -(node + 1);
}

__global__ void __launch_bounds__(kThreads) bin_rows_kernel(
    const float* __restrict__ X, long long N, int F, const float* __restrict__ bounds, int bmax,
    const unsigned char* __restrict__ is_cat, int* __restrict__ codes,
    unsigned char* __restrict__ isnan_out) {
  const long long total = N * F;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    const int f = (int)(i % F);
    const float x = X[i];
    const bool nan = x != x;
    const float v = nan ? 0.0f : x;
    int code;
    if (is_cat[f]) {
      code = (int)truncf(fminf(fmaxf(v, -2.0e9f), 2.0e9f));
    } else {
      const float* b = bounds + (long long)f * bmax;
      int lo = 0, hi = bmax;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (b[mid] < v) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      code = lo;
    }
    codes[i] = code;
    isnan_out[i] = nan;
  }
}

__global__ void __launch_bounds__(kThreads) leaves_kernel(
    const int* __restrict__ codes, const unsigned char* __restrict__ isnan, long long N, int F,
    Ensemble e, int* __restrict__ out) {
  extern __shared__ int4 nodes[];  // [2 M]
  for (int t = blockIdx.y; t < e.T; t += gridDim.y) {
    const int nl = e.num_leaves[t];
    const int m = min(max(nl - 1, 0), e.M);
    __syncthreads();  // the previous tree's walks are done with the nodes
    stage(e.table + 2LL * t * e.M, nodes, 2 * m);
    __syncthreads();
    for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < N;
         r += (long long)gridDim.x * kThreads) {
      out[(long long)t * N + r] = walk(nodes, nl, codes + r * F, isnan + r * F, e);
    }
  }
}

__global__ void __launch_bounds__(kThreads) values_kernel(
    const int* __restrict__ codes, const unsigned char* __restrict__ isnan, long long N, int F,
    Ensemble e, const float* __restrict__ leaf_value, int L, int K, int average,
    float* __restrict__ out) {
  extern __shared__ int4 smem[];
  int4* nodes = smem;                                                // [kTrees][2 M]
  float* vals = reinterpret_cast<float*>(smem + 2 * kTrees * e.M);  // [kTrees][kTileRows]
  float* acc = vals + kTrees * kTileRows;                            // [K][kTileRows]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int iters = max(e.T / max(K, 1), 1);
  for (long long r0 = (long long)blockIdx.x * kTileRows; r0 < N; r0 += (long long)gridDim.x * kTileRows) {
    const long long r = r0 + lane;
    __syncthreads();  // the previous tile's accumulators are written out
    for (int i = threadIdx.x; i < K * kTileRows; i += kThreads) acc[i] = 0.0f;
    for (int i0 = 0; i0 < e.T; i0 += kTrees) {
      const int nt = min(kTrees, e.T - i0);
      __syncthreads();  // warp 0 has summed the previous round's values
      stage(e.table + 2LL * i0 * e.M, nodes, 2 * nt * e.M);  // the round's trees, padding too
      __syncthreads();
      if (warp < nt && r < N) {
        const int t = i0 + warp;
        const int leaf = walk(nodes + 2 * warp * e.M, e.num_leaves[t], codes + r * F,
                              isnan + r * F, e);
        vals[warp * kTileRows + lane] = leaf_value[(long long)t * L + leaf];
      }
      __syncthreads();
      if (warp == 0 && r < N) {
        for (int w = 0; w < nt; ++w) acc[((i0 + w) % K) * kTileRows + lane] += vals[w * kTileRows + lane];
      }
    }
    __syncthreads();
    if (warp == 0 && r < N) {
      for (int k = 0; k < K; ++k) {
        const float s = acc[k * kTileRows + lane];
        out[(long long)k * N + r] = average ? s / (float)iters : s;
      }
    }
  }
}

Ensemble make_ensemble(const int* table, const int* num_leaves, const uint32_t* cat_words,
                       const int* rank0, const int* zero_lo, const int* zero_hi, int T, int M) {
  Ensemble e;
  e.table = reinterpret_cast<const int4*>(table);
  e.num_leaves = num_leaves;
  e.cat_words = cat_words;
  e.rank0 = rank0;
  e.zero_lo = zero_lo;
  e.zero_hi = zero_hi;
  e.T = T;
  e.M = M;
  return e;
}

int ensure_shared(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// codes [N, F] int32 and isnan [N, F] bool of the f32 rows X [N, F];
// bounds [F, bmax] f32 (padded with +inf), is_cat [F] bool.
int lgbt_packed_bin_rows(const float* X, long long N, int F, const float* bounds, int bmax,
                         const unsigned char* is_cat, int* codes, unsigned char* isnan_out,
                         int grid, cudaStream_t stream) {
  bin_rows_kernel<<<grid, kThreads, 0, stream>>>(X, N, F, bounds, bmax, is_cat, codes, isnan_out);
  return (int)cudaGetLastError();
}

// out [T, N] int32: each row's leaf in each tree; ``table`` the [T, M, 8]
// int32 node table (16-byte aligned); grid_x tiles of 256 rows by grid_y
// trees (a block loops over the trees past grid_y).
int lgbt_packed_predict_leaves(const int* codes, const unsigned char* isnan, long long N, int F,
                               const int* table, const int* num_leaves, const uint32_t* cat_words,
                               const int* rank0, const int* zero_lo, const int* zero_hi, int T,
                               int M, int* out, int grid_x, int grid_y, cudaStream_t stream) {
  const Ensemble e = make_ensemble(table, num_leaves, cat_words, rank0, zero_lo, zero_hi, T, M);
  const size_t shared = (size_t)2 * M * sizeof(int4);
  int err = ensure_shared((const void*)leaves_kernel, shared);
  if (err != 0) return err;
  leaves_kernel<<<dim3(grid_x, grid_y), kThreads, shared, stream>>>(codes, isnan, N, F, e, out);
  return (int)cudaGetLastError();
}

// out [K, N] f32: tree i's leaf value added into class i % K, in tree order,
// divided by max(T / K, 1) when ``average``; grid tiles of 32 rows.
int lgbt_packed_predict_values(const int* codes, const unsigned char* isnan, long long N, int F,
                               const int* table, const int* num_leaves, const uint32_t* cat_words,
                               const int* rank0, const int* zero_lo, const int* zero_hi, int T,
                               int M, const float* leaf_value, int L, int K, int average,
                               float* out, int grid, cudaStream_t stream) {
  const Ensemble e = make_ensemble(table, num_leaves, cat_words, rank0, zero_lo, zero_hi, T, M);
  const size_t shared = (size_t)2 * kTrees * M * sizeof(int4) +
                        (size_t)(kTrees + K) * kTileRows * sizeof(float);
  int err = ensure_shared((const void*)values_kernel, shared);
  if (err != 0) return err;
  values_kernel<<<grid, kThreads, shared, stream>>>(codes, isnan, N, F, e, leaf_value, L, K,
                                                      average, out);
  return (int)cudaGetLastError();
}

// The most dynamic shared memory a block may take on this device (bytes).
int lgbt_packed_max_shared(int device, int* bytes) {
  return (int)cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

}  // extern "C"
