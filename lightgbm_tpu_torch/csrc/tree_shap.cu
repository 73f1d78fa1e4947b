// Exact TreeSHAP on raw f64 rows, for Hopper (sm_90a): tree_shap_kernel
// (each (tree, row)'s SHAP values into a per-tree partial) and
// tree_sum_kernel (the partials added into each class in tree order).
//
// Replaces no TPU kernel: the JAX package computes SHAP values on the host,
// in Python, row by row (lightgbm_tpu/models/tree.py ``predict_contrib_row``,
// Tree::TreeSHAP with ExtendPath, UnwindPath and UnwoundPathSum, tree.h:
// 286-470, summed by lightgbm_tpu/models/gbdt.py ``predict_contrib``). It
// exists because the port's entry points run on the card, and there no plain
// tensor version runs at full width: the recursion is a few hundred f64
// operations a path position, d^2 of them a leaf, for every leaf of every
// tree of every row. Its plain version is ops/shap.py ``contrib_plain``,
// equal bit for bit.
//
// What it computes: for the rows X [N, ldx] f64 and the trees t0..t0+C-1 of
// a ShapTrees table (ops/shap_kernel.py), partial[c, r, :] = the SHAP values
// of tree t0 + c for row r, [F + 1] f64 starting from 0.0 (zeroed by the
// wrapper), the tree's expected value added into column F first, then each
// leaf's contributions in the recursion's order: the row's hot child first
// (Tree._decide in f64), path positions 1..depth in order. The second
// kernel adds partial[c] into out[(t0 + c) % K] for c in order, which is
// ``out[i % K] += t.predict_contrib(X, F)``.
//
// Design, right and simple first: one thread a (tree, row). A block owns a
// tile of 128 rows of one tree, stages the tree's nodes (40 bytes) and
// leaves (16 bytes) in shared memory when they fit in 48 KB (a 255-leaf
// tree takes 14 KB; a larger one is read from global memory), and loops
// over tiles by a grid stride. The recursion is an explicit stack of
// pending cold children. The path arrays (feature, zero fraction, one
// fraction, permutation weight) use the reference's triangular layout,
// maxd (maxd + 1) / 2 + maxd positions with maxd = the deepest tree's depth
// + 2, so a subtree never writes over its parent's path; they and the stack
// live in a global scratch the wrapper sizes from the model, one slot a
// resident thread, each slot contiguous: a warp's rows walk different paths,
// so a thread's neighbouring positions share its sectors and L1 keeps them
// (PERF.md §6, the TreeSHAP probes: 1.29x the slots interleaved position by
// position; a copy of each leaf's weights in shared memory was slower still,
// costing a block an SM). Every depth the model has fits: a chain of 254
// levels takes 935 KB a slot, and the wrapper then launches as few threads
// as the scratch allows.
//
// Bits: built with --fmad=false (ops/cuda_build.py), and every expression
// keeps the Python's order of f64 operations, so each value is the one
// numpy rounds; a zero fraction of 0 gives IEEE inf or nan as numpy does.
//
// What bounds it: f64 operations, the path arithmetic of the extends,
// unwinds and unwound sums, d^2 a leaf for a leaf at depth d; the bytes are
// the rows, the trees and the [N, K, F + 1] output. In practice the
// scratch traffic of the path arrays and the divergence of a warp's rows
// through different paths.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMissingZero = 1, kMissingNan = 2;  // ops/split.py MISSING_*
constexpr double kZeroThreshold = 1e-35;
constexpr int kCategorical = 1, kDefaultLeft = 2, kLegacyCategorical = 16;

struct Node {  // 40 bytes, ops/shap_kernel.py NODE_DTYPE
  double threshold;
  double count;  // internal_count
  int feature, left, right;  // children: node, or ~leaf
  int flags;  // decision_type | kLegacyCategorical (categorical, no bitsets)
  int cat_lo, cat_nw;  // the node's bitset: its first word in the pool, its words
};

struct Leaf {  // 16 bytes, ops/shap_kernel.py LEAF_DTYPE
  double value;
  double count;
};

// The path arrays and the stack; in a thread, its own slot's (``slot``).
struct Scratch {
  int* fidx;
  double* zf;
  double* of;
  double* pw;
  int* st_node;
  int* st_depth;
  int* st_poff;
  int* st_pfi;
  double* st_pzf;
  double* st_pof;
  int P, Q;  // path positions and stack frames a slot

  __device__ Scratch slot(long long s) const {
    Scratch q = *this;
    const long long a = s * P, b = s * Q;
    q.fidx += a;
    q.zf += a;
    q.of += a;
    q.pw += a;
    q.st_node += b;
    q.st_depth += b;
    q.st_poff += b;
    q.st_pfi += b;
    q.st_pzf += b;
    q.st_pof += b;
    return q;
  }
};

// Tree._decide (lightgbm_tpu/models/tree.py): NumericalDecision and
// CategoricalDecision (tree.h:216-271) in f64.
__device__ __forceinline__ bool decide(const Node& nd, double fval, const uint32_t* words) {
  const int miss = (nd.flags >> 2) & 3;
  if (nd.flags & kCategorical) {
    if (nd.flags & kLegacyCategorical) {
      if (isnan(fval)) return false;
      return trunc(fval) == trunc(nd.threshold);
    }
    int iv;
    if (isnan(fval)) {
      if (miss == kMissingNan) return false;  // NaN is always right
      iv = 0;
    } else {
      const double tv = trunc(fval);  // int(fval)
      if (tv < 0.0 || tv >= 2147483648.0) return false;
      iv = (int)tv;
    }
    if ((iv >> 5) >= nd.cat_nw) return false;
    return (words[nd.cat_lo + (iv >> 5)] >> (iv & 31)) & 1u;
  }
  if (isnan(fval) && miss != kMissingNan) fval = 0.0;
  if ((miss == kMissingZero && fval > -kZeroThreshold && fval <= kZeroThreshold) ||
      (miss == kMissingNan && isnan(fval)))
    return (nd.flags & kDefaultLeft) != 0;
  return fval <= nd.threshold;
}

__device__ __forceinline__ double data_count(const Node* nodes, const Leaf* leaves, int child) {
  return child < 0 ? leaves[~child].count : nodes[child].count;
}

// ExtendPath (tree.py ``extend``).
__device__ void extend(const Scratch& p, int off, int depth, double pzf, double pof,
                       int pfi) {
  const int at = off + depth;
  p.fidx[at] = pfi;
  p.zf[at] = pzf;
  p.of[at] = pof;
  p.pw[at] = depth == 0 ? 1.0 : 0.0;
  for (int i = depth - 1; i >= 0; --i) {
    const int a = off + i;
    const int b = a + 1;
    p.pw[b] += pof * p.pw[a] * (i + 1) / (depth + 1);
    p.pw[a] = pzf * p.pw[a] * (depth - i) / (depth + 1);
  }
}

// UnwindPath (tree.py ``unwind``).
__device__ void unwind(const Scratch& p, int off, int depth, int pi) {
  const double one = p.of[off + pi];
  const double zero = p.zf[off + pi];
  double nxt = p.pw[off + depth];
  for (int i = depth - 1; i >= 0; --i) {
    const int a = off + i;
    if (one != 0.0) {
      const double tmp = p.pw[a];
      p.pw[a] = nxt * (depth + 1) / ((i + 1) * one);
      nxt = tmp - p.pw[a] * zero * (depth - i) / (depth + 1);
    } else {
      p.pw[a] = p.pw[a] * (depth + 1) / (zero * (depth - i));
    }
  }
  for (int i = pi; i < depth; ++i) {
    const int a = off + i;
    p.fidx[a] = p.fidx[a + 1];
    p.zf[a] = p.zf[a + 1];
    p.of[a] = p.of[a + 1];
  }
}

// UnwoundPathSum (tree.py ``unwound_sum``).
__device__ double unwound_sum(const Scratch& p, int off, int depth, int pi) {
  const double one = p.of[off + pi];
  const double zero = p.zf[off + pi];
  double nxt = p.pw[off + depth];
  double total = 0.0;
  for (int i = depth - 1; i >= 0; --i) {
    const double w = p.pw[off + i];
    const double c = (double)(depth - i) / (double)(depth + 1);
    if (one != 0.0) {
      const double tmp = nxt * (depth + 1) / ((i + 1) * one);
      total += tmp;
      nxt = w - tmp * zero * c;
    } else {
      total += (w / zero) / c;
    }
  }
  return total;
}

// One row through one tree (tree.py ``shap``, its recursion as a stack of
// pending cold children): the contributions added into phi [F + 1].
__device__ void shap_row(const Node* nodes, const Leaf* leaves, const uint32_t* words,
                         const double* x, double* phi, const Scratch& p) {
  int sp = 0;
  auto push = [&](int node, int depth, int poff, double pzf, double pof, int pfi) {
    p.st_node[sp] = node;
    p.st_depth[sp] = depth;
    p.st_poff[sp] = poff;
    p.st_pfi[sp] = pfi;
    p.st_pzf[sp] = pzf;
    p.st_pof[sp] = pof;
    ++sp;
  };
  push(0, 0, 0, 1.0, 1.0, -1);
  while (sp > 0) {
    --sp;
    const int node = p.st_node[sp], depth = p.st_depth[sp], poff = p.st_poff[sp];
    const int pfi = p.st_pfi[sp];
    const double pzf = p.st_pzf[sp], pof = p.st_pof[sp];
    const int off = poff + depth;
    for (int i = 0; i < depth; ++i) {  // the parent's path, below the child's
      const int dst = off + i, src = poff + i;
      p.fidx[dst] = p.fidx[src];
      p.zf[dst] = p.zf[src];
      p.of[dst] = p.of[src];
      p.pw[dst] = p.pw[src];
    }
    extend(p, off, depth, pzf, pof, pfi);
    if (node < 0) {
      const double leaf_out = leaves[~node].value;
      for (int i = 1; i <= depth; ++i) {
        const double w = unwound_sum(p, off, depth, i);
        const int at = off + i;
        phi[p.fidx[at]] += w * (p.of[at] - p.zf[at]) * leaf_out;
      }
      continue;
    }
    const Node nd = nodes[node];
    const bool left = decide(nd, x[nd.feature], words);
    const int hot = left ? nd.left : nd.right;
    const int cold = left ? nd.right : nd.left;
    const double w = nd.count;
    const double hot_zf = w > 0 ? data_count(nodes, leaves, hot) / w : 0.0;
    const double cold_zf = w > 0 ? data_count(nodes, leaves, cold) / w : 0.0;
    double inc_zf = 1.0, inc_of = 1.0;
    int d = depth;
    int pi = 0;
    for (; pi <= d; ++pi) {
      if (p.fidx[off + pi] == nd.feature) break;
    }
    if (pi != d + 1) {  // already split on this feature: undo that extension
      inc_zf = p.zf[off + pi];
      inc_of = p.of[off + pi];
      unwind(p, off, d, pi);
      --d;
    }
    push(cold, d + 1, off, cold_zf * inc_zf, 0.0, nd.feature);
    push(hot, d + 1, off, hot_zf * inc_zf, inc_of, nd.feature);
  }
}

__global__ void __launch_bounds__(kThreads)
tree_shap_kernel(const double* __restrict__ X, long long N, long long ldx, int F,
                 const Node* __restrict__ gnodes, const Leaf* __restrict__ gleaves,
                 const uint32_t* __restrict__ words, const double* __restrict__ expected,
                 const int* __restrict__ num_leaves, int t0, int C, int M, int L, int staged,
                 Scratch p, double* __restrict__ partial) {
  extern __shared__ double smem[];
  const long long row_tiles = (N + kThreads - 1) / kThreads;
  const long long tiles = row_tiles * C;
  const Scratch q = p.slot((long long)blockIdx.x * kThreads + threadIdx.x);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int c = (int)(tile / row_tiles);
    const int t = t0 + c;
    const long long r = (tile % row_tiles) * kThreads + threadIdx.x;
    const Node* nodes = gnodes + (long long)t * M;
    const Leaf* leaves = gleaves + (long long)t * L;
    if (staged) {
      const int nd = M * (int)(sizeof(Node) / sizeof(double));
      const int lv = L * (int)(sizeof(Leaf) / sizeof(double));
      const double* src_n = reinterpret_cast<const double*>(nodes);
      const double* src_l = reinterpret_cast<const double*>(leaves);
      __syncthreads();  // the previous tile's rows are done with the old tree
      for (int i = threadIdx.x; i < nd; i += kThreads) smem[i] = src_n[i];
      for (int i = threadIdx.x; i < lv; i += kThreads) smem[nd + i] = src_l[i];
      __syncthreads();
      nodes = reinterpret_cast<const Node*>(smem);
      leaves = reinterpret_cast<const Leaf*>(smem + nd);
    }
    if (r >= N) continue;
    double* phi = partial + ((long long)c * N + r) * (F + 1);
    phi[F] += expected[t];
    if (num_leaves[t] <= 1) continue;
    shap_row(nodes, leaves, words, X + r * ldx, phi, q);
  }
}

// out [K, N, F + 1] += partial[c] for tree t0 + c into class (t0 + c) % K, c in order.
__global__ void __launch_bounds__(256)
tree_sum_kernel(const double* __restrict__ partial, long long N, int F, int K, int t0, int C,
                double* __restrict__ out) {
  const long long per_class = N * (F + 1);
  const long long total = per_class * K;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int k = (int)(i / per_class);
    const long long rc = i % per_class;
    double acc = out[i];
    for (int c = ((k - t0) % K + K) % K; c < C; c += K) acc += partial[(long long)c * per_class + rc];
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

// The blocks of each kernel that the current device holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the SM count), for
// tree_shap_kernel with ``shared`` bytes of staged tree a block: the grids
// of lgbt_tree_shap and lgbt_tree_sum need no more.
int lgbt_tree_shap_grid(int* shap_blocks, int* sum_blocks, long long shared) {
  int dev = 0, sms = 0, shap_per_sm = 0, sum_per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&shap_per_sm, tree_shap_kernel, kThreads,
                                                        (size_t)shared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&sum_per_sm, tree_sum_kernel, 256, 0);
  *shap_blocks = shap_per_sm * sms;
  *sum_blocks = sum_per_sm * sms;
  return (int)err;
}

// partial [C, N, F + 1] f64 (zeroed): the SHAP values of trees t0..t0+C-1
// for the rows X (row stride ldx); the scratch arrays hold ``path``
// positions and ``stack`` frames for each of grid * 128 slots, a slot's
// contiguous; grid at most lgbt_tree_shap_grid's shap_blocks.
int lgbt_tree_shap(const double* X, long long N, long long ldx, int F, const void* nodes,
                   const void* leaves, const uint32_t* words, const double* expected,
                   const int* num_leaves, int t0, int C, int M, int L, int staged, int* fidx,
                   double* zf, double* of, double* pw, int* st_int,
                   double* st_dbl, int path, int stack, double* partial, int grid,
                   cudaStream_t stream) {
  const long long frames = (long long)stack * grid * kThreads;
  Scratch p;
  p.P = path;
  p.Q = stack;
  p.fidx = fidx;
  p.zf = zf;
  p.of = of;
  p.pw = pw;
  p.st_node = st_int;
  p.st_depth = st_int + frames;
  p.st_poff = st_int + 2 * frames;
  p.st_pfi = st_int + 3 * frames;
  p.st_pzf = st_dbl;
  p.st_pof = st_dbl + frames;
  const size_t shared = staged ? (size_t)M * sizeof(Node) + (size_t)L * sizeof(Leaf) : 0;
  tree_shap_kernel<<<grid, kThreads, shared, stream>>>(
      X, N, ldx, F, static_cast<const Node*>(nodes), static_cast<const Leaf*>(leaves), words,
      expected, num_leaves, t0, C, M, L, staged, p, partial);
  return (int)cudaGetLastError();
}

// out [K, N, F + 1] f64 += each partial into its tree's class, in tree order.
int lgbt_tree_sum(const double* partial, long long N, int F, int K, int t0, int C, double* out,
                  int grid, cudaStream_t stream) {
  tree_sum_kernel<<<grid, 256, 0, stream>>>(partial, N, F, K, t0, C, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
