// Each row's leaf of one tree in bin space, fused with the score update it
// feeds, for Hopper (sm_90a): predict_bins.
//
// Counterpart of lightgbm_tpu/ops/predict.py ``tree_predict_leaf`` /
// ``tree_predict_value`` (all rows advance one level a step of a
// lax.while_loop over node-index vectors) and of the validation-score update
// after each tree (lightgbm_tpu/models/gbdt.py ``_update_valid_scores``, an
// ``.at[class].add``). It replaces no Pallas kernel: the reference leaves the
// traversal to XLA. Its plain version is ops/predict.py ``add_tree_value``,
// equal bit for bit: the traversal is integer work, and the update is one f32
// add a row, ``score[r] += value[leaf(r)]``.
//
// Layout: one thread per row (a grid-stride loop over rows). Each block
// first stages the tree's grown nodes in shared memory, 16 bytes a node:
// the feature, one word packing the threshold bin, the feature's default
// bin, its NaN bin (num_bin - 1), its missing type and the node's
// default_left, and the two children. The nodes come from a split loop's
// ``node_i`` rows (feature, threshold, left, right, default_left) and the
// feature meta; their count from ``*num_leaves`` in device memory, so the
// kernel runs inside a captured CUDA graph with nothing read back. A row
// then walks from the root to its leaf, one byte of its bins a level, read
// from the row-major [N, F] bin matrix: a row's F bytes share one or two
// 32-byte sectors, so after the first level the walk reads from L1.
//
// What bounds it: bytes. It must read each row's bins on its path (about
// the mean depth in bytes) and read and write its f32 score: N x (8 + mean
// depth) bytes, 9.5 MB at 500k rows and a depth of 11, about 3 us of the
// card's memory rate. The walk is a chain of dependent shared and L1 loads
// per row (two a level), so latency is hidden only by the rows in flight:
// 256 threads a block, several blocks an SM.
//
// Categorical nodes (the kCat instantiation, launched for a table with
// categorical features): the rule word's bit 27 marks a categorical node,
// and each block stages the nodes' membership words (W = ceil(B / 32) a
// node, from the split loop's node_b) in shared memory after the nodes:
// 255 x 8 words, 8 KB, at 255 leaves and 256 bins. A categorical node's
// decision is one word's bit at the row's bin, with no default direction
// (lightgbm_tpu/ops/predict.py:113-114).
//
// EFB-bundled tables (predict_bins_bundled_kernel, launched when the bins are
// the [N, G] groups of lightgbm_tpu/efb.py): each node carries its column
// (its feature's group) and its offset in the node's first word, column |
// offset << 24 (G < 2^24, offsets < 256), staged with its rule; a row reads
// the node's column and decodes the byte to the feature's sub-bin before
// the missing and categorical tests (lightgbm_tpu/ops/predict.py:104-109:
// r = bin - offset; r + (r >= default_bin) where 0 <= r < num_bin - 1,
// else default_bin). It takes 4 blocks an SM as its launch bound (64
// registers a thread: at the default bound its decode spilled). An
// unbundled table runs predict_bins_kernel, unchanged.
//
// Wide bins (the kWide instantiation, for int16 bins of up to 1024 bins a
// feature): a row reads two bytes a level, and a node's rule keeps 10 bits
// each for the threshold, the default bin and the NaN bin (its missing type
// moves to the feature word's top bits); a categorical node's words are W
// = 32 at 1024 bins, 32 KB beside the nodes at 255 leaves. The byte
// instantiations keep their code. A bundled table with int16 groups (a
// group of more than 256 bins, predict_bins_bundled_kernel<kCat, true>):
// the node's first word packs its column in 18 bits, its offset in 10 and
// its missing type in 2 (G < 2^18), its rule as the wide one's, and the
// two-byte group bin is decoded as the byte one is.
//
// ``value`` is what a row at each leaf adds (the device iteration passes the
// shrunk leaf values where the tree grew and exact zeros where it did not);
// ``leaf_out``, when not null, receives each row's leaf.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMissingZero = 1, kMissingNan = 2;  // ops/split.py MISSING_*
constexpr int kStaticSharedBytes = 48 * 1024;

constexpr int kBundledMinBlocks = 4;  // bundled: 64 registers a thread (32 spilled its decode)

// a bin of the byte or the int16 (kWide) instantiations
template <bool kWide>
using Bin = std::conditional_t<kWide, int16_t, uint8_t>;

// The traversal of every row, shared by the kernels below.
template <bool kCat, bool kEfb, bool kWide = false>
__device__ __forceinline__ void predict_rows(
    const Bin<kWide>* __restrict__ bins, long long N, int F, const int* __restrict__ node_i,
    int max_nodes, const int* __restrict__ num_leaves, const int* __restrict__ missing_type,
    const int* __restrict__ default_bin, const int* __restrict__ num_bin,
    const float* __restrict__ value, float* __restrict__ score, int* __restrict__ leaf_out,
    const int* __restrict__ node_b, const unsigned char* __restrict__ is_cat, int W,
    const int* __restrict__ gid, const int* __restrict__ off) {
  extern __shared__ int4 nodes[];  // x feature (kEfb: column | offset << 24), y rule, z left, w right
  const int m = min(max(*num_leaves - 1, 0), max_nodes);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int* rec = node_i + 5LL * i;
    const int f = rec[0];
    if constexpr (kWide) {
      // x: feature | missing_type << 28; y: threshold, default bin and NaN
      // bin in 10 bits each, default_left at bit 30, categorical at 31
      const unsigned rule = (rec[1] & 0x3FFu) | ((default_bin[f] & 0x3FFu) << 10) |
                            (((num_bin[f] - 1) & 0x3FFu) << 20) | ((rec[4] != 0 ? 1u : 0u) << 30) |
                            (kCat && is_cat[f] ? 1u << 31 : 0u);
      if constexpr (kEfb) {  // column | offset << 18 | missing_type << 28
        nodes[i] = make_int4(gid[f] | ((off[f] & 0x3FF) << 18) | ((missing_type[f] & 3) << 28),
                             (int)rule, rec[2], rec[3]);
      } else {
        nodes[i] = make_int4(f | ((missing_type[f] & 3) << 28), (int)rule, rec[2], rec[3]);
      }
    } else {
      const int rule = (rec[1] & 0xFF) | ((default_bin[f] & 0xFF) << 8) |
                       (((num_bin[f] - 1) & 0xFF) << 16) | ((missing_type[f] & 3) << 24) |
                       ((rec[4] != 0) << 26) | (kCat && is_cat[f] ? 1 << 27 : 0);
      nodes[i] = make_int4(kEfb ? gid[f] | (off[f] << 24) : f, rule, rec[2], rec[3]);
    }
  }
  int* words = reinterpret_cast<int*>(nodes + max_nodes);  // [max_nodes, W] (kCat)
  if (kCat) {
    for (int i = threadIdx.x; i < m * W; i += kThreads) words[i] = node_b[i];
  }
  __syncthreads();
  for (long long r = blockIdx.x * (long long)kThreads + threadIdx.x; r < N;
       r += (long long)gridDim.x * kThreads) {
    const Bin<kWide>* row = bins + r * F;
    int node = m > 0 ? 0 : -1;  // a tree that did not split: every row at leaf 0
    while (node >= 0) {
      const int4 nd = nodes[node];
      if constexpr (kWide) {
        const unsigned rule = (unsigned)nd.y;
        int col;
        if constexpr (kEfb) {  // the group bin as the node feature's sub-bin
          const int sub = (int)row[nd.x & 0x3FFFF] - (int)(((unsigned)nd.x >> 18) & 0x3FFu);
          const int dbin = (rule >> 10) & 0x3FF;
          col = (sub >= 0 && sub < (int)((rule >> 20) & 0x3FF)) ? sub + (sub >= dbin) : dbin;
        } else {
          col = row[nd.x & 0xFFFFFFF];
        }
        const int miss = ((unsigned)nd.x >> 28) & 3;
        bool left = col <= (int)(rule & 0x3FF);
        if ((miss == kMissingZero && col == (int)((rule >> 10) & 0x3FF)) ||
            (miss == kMissingNan && col == (int)((rule >> 20) & 0x3FF))) {
          left = (rule >> 30) & 1;
        }
        if (kCat && (rule >> 31)) left = (words[node * W + (col >> 5)] >> (col & 31)) & 1;
        node = left ? nd.z : nd.w;
        continue;
      }
      const int rule = nd.y;
      int col;
      if (kEfb) {
        const int sub = (int)row[nd.x & 0xFFFFFF] - (int)((unsigned)nd.x >> 24);
        const int dbin = (rule >> 8) & 0xFF;
        col = (sub >= 0 && sub < ((rule >> 16) & 0xFF)) ? sub + (sub >= dbin) : dbin;
      } else {
        col = row[nd.x];
      }
      const int miss = (rule >> 24) & 3;
      bool left = col <= (rule & 0xFF);
      if ((miss == kMissingZero && col == ((rule >> 8) & 0xFF)) ||
          (miss == kMissingNan && col == ((rule >> 16) & 0xFF))) {
        left = (rule >> 26) & 1;
      }
      if (kCat && ((rule >> 27) & 1)) left = (words[node * W + (col >> 5)] >> (col & 31)) & 1;
      node = left ? nd.z : nd.w;
    }
    const int leaf = -(node + 1);
    score[r] += value[leaf];
    if (leaf_out != nullptr) leaf_out[r] = leaf;
  }
}

// an unbundled table (kWide: int16 bins)
template <bool kCat, bool kWide>
__global__ void __launch_bounds__(kThreads)
predict_bins_kernel(const Bin<kWide>* __restrict__ bins, long long N, int F,
                    const int* __restrict__ node_i, int max_nodes,
                    const int* __restrict__ num_leaves, const int* __restrict__ missing_type,
                    const int* __restrict__ default_bin, const int* __restrict__ num_bin,
                    const float* __restrict__ value, float* __restrict__ score,
                    int* __restrict__ leaf_out, const int* __restrict__ node_b,
                    const unsigned char* __restrict__ is_cat, int W) {
  predict_rows<kCat, false, kWide>(bins, N, F, node_i, max_nodes, num_leaves, missing_type,
                                   default_bin, num_bin, value, score, leaf_out, node_b, is_cat,
                                   W, nullptr, nullptr);
}

// an EFB-bundled table: the decode's registers, at kBundledMinBlocks blocks an SM
// (kWide: int16 groups)
template <bool kCat, bool kWide = false>
__global__ void __launch_bounds__(kThreads, kBundledMinBlocks)
predict_bins_bundled_kernel(const Bin<kWide>* __restrict__ bins, long long N, int F,
                            const int* __restrict__ node_i, int max_nodes,
                            const int* __restrict__ num_leaves,
                            const int* __restrict__ missing_type,
                            const int* __restrict__ default_bin, const int* __restrict__ num_bin,
                            const float* __restrict__ value, float* __restrict__ score,
                            int* __restrict__ leaf_out, const int* __restrict__ node_b,
                            const unsigned char* __restrict__ is_cat, int W,
                            const int* __restrict__ gid, const int* __restrict__ off) {
  predict_rows<kCat, true, kWide>(bins, N, F, node_i, max_nodes, num_leaves, missing_type,
                                  default_bin, num_bin, value, score, leaf_out, node_b, is_cat, W,
                                  gid, off);
}

// the dynamic shared memory each kernel may take (bit 0 categorical, bit 1
// bundled, bit 2 int16 bins)
int configured_shared_bytes[8] = {kStaticSharedBytes, kStaticSharedBytes, kStaticSharedBytes,
                                  kStaticSharedBytes, kStaticSharedBytes, kStaticSharedBytes,
                                  kStaticSharedBytes, kStaticSharedBytes};

}  // namespace

extern "C" {

// score[r] += value[leaf(r)] for the N rows of bins [N, F] (uint8, or int16
// with bin_bytes 2) through the tree of *num_leaves leaves whose first
// num_leaves - 1 nodes are rows of node_i [max_nodes, 5] int32;
// missing_type / default_bin / num_bin [F] int32; leaf_out [N] int32 or
// null. With categorical features, node_b [max_nodes, W] int32 (each node's
// membership words) and is_cat [F] bytes; is_cat null without them. An
// EFB-bundled table (int16 groups: G < 2^18): bins [N, F] holds F group columns, and gid
// / off [features] int32 give each feature's group and offset (both null
// unbundled). Shared memory: 16 bytes a node, and 4 W bytes a node with
// categorical features.
int lgbt_predict_bins(const void* bins, long long N, int F, const void* node_i, int max_nodes,
                      const void* num_leaves, const void* missing_type, const void* default_bin,
                      const void* num_bin, const void* value, void* score, void* leaf_out,
                      const void* node_b, const void* is_cat, int W, const void* gid,
                      const void* off, int bin_bytes, int grid, void* stream) {
  if (N < 1 || F < 1 || max_nodes < 0 || grid < 1) return (int)cudaErrorInvalidValue;
  const bool cat = is_cat != nullptr;
  const bool efb = gid != nullptr;
  const bool wide = bin_bytes == 2;
  if (bin_bytes != 1 && !wide) return (int)cudaErrorInvalidValue;
  if (cat && (node_b == nullptr || W < 1)) return (int)cudaErrorInvalidValue;
  if (efb != (off != nullptr) || (efb && F >= (1 << 24))) return (int)cudaErrorInvalidValue;
  if (wide && F >= (efb ? (1 << 18) : (1 << 28))) return (int)cudaErrorInvalidValue;
  const int slots = max_nodes > 1 ? max_nodes : 1;
  const int shared = slots * (int)sizeof(int4) + (cat ? slots * W * (int)sizeof(int) : 0);
  const int kind = (cat ? 1 : 0) | (efb ? 2 : 0) | (wide ? 4 : 0);
  const void* kern =
      efb ? (wide ? (cat ? (const void*)&predict_bins_bundled_kernel<true, true>
                         : (const void*)&predict_bins_bundled_kernel<false, true>)
                  : (cat ? (const void*)&predict_bins_bundled_kernel<true>
                         : (const void*)&predict_bins_bundled_kernel<false>))
          : wide ? (cat ? (const void*)&predict_bins_kernel<true, true>
                        : (const void*)&predict_bins_kernel<false, true>)
                 : (cat ? (const void*)&predict_bins_kernel<true, false>
                        : (const void*)&predict_bins_kernel<false, false>);
  if (shared > configured_shared_bytes[kind]) {
    // above 48 KB only as dynamic shared memory with the attribute raised;
    // raised once, before any captured launch needs it
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    configured_shared_bytes[kind] = shared;
  }
  const uint8_t* b = (const uint8_t*)bins;
  const int *ni = (const int*)node_i, *nl = (const int*)num_leaves;
  const int *mt = (const int*)missing_type, *db = (const int*)default_bin;
  const int* nbn = (const int*)num_bin;
  const float* v = (const float*)value;
  float* sc = (float*)score;
  int* lo = (int*)leaf_out;
  const int* nb = (const int*)node_b;
  const unsigned char* ic = (const unsigned char*)is_cat;
  cudaStream_t st = (cudaStream_t)stream;
  if (efb && wide) {
    const int *g = (const int*)gid, *o = (const int*)off;
    const int16_t* b16 = (const int16_t*)bins;
    if (cat)
      predict_bins_bundled_kernel<true, true><<<grid, kThreads, shared, st>>>(
          b16, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W, g, o);
    else
      predict_bins_bundled_kernel<false, true><<<grid, kThreads, shared, st>>>(
          b16, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W, g, o);
  } else if (efb) {
    const int *g = (const int*)gid, *o = (const int*)off;
    if (cat)
      predict_bins_bundled_kernel<true><<<grid, kThreads, shared, st>>>(
          b, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W, g, o);
    else
      predict_bins_bundled_kernel<false><<<grid, kThreads, shared, st>>>(
          b, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W, g, o);
  } else if (wide) {
    const int16_t* b16 = (const int16_t*)bins;
    if (cat)
      predict_bins_kernel<true, true><<<grid, kThreads, shared, st>>>(
          b16, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W);
    else
      predict_bins_kernel<false, true><<<grid, kThreads, shared, st>>>(
          b16, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W);
  } else if (cat) {
    predict_bins_kernel<true, false><<<grid, kThreads, shared, st>>>(
        b, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W);
  } else {
    predict_bins_kernel<false, false><<<grid, kThreads, shared, st>>>(
        b, N, F, ni, max_nodes, nl, mt, db, nbn, v, sc, lo, nb, ic, W);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
