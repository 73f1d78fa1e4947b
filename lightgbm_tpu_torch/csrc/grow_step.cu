// The per-split bookkeeping of the device-resident split loop for Hopper
// (sm_90a): the pick and the tree wiring (grow_step), and the histogram
// subtraction (hist_subtract). Both read every leaf index from the loop's
// control vector in device memory, so the host launches a step without
// reading anything back.
//
// A third kernel, leaf_ids, runs once a tree after the loop: each row's
// leaf from the segment layout, the counterpart of the reconstruction after
// the reference's loop (lightgbm_tpu/ops/grow.py:1880-1893, an argsort and
// a searchsorted over the leaves' begins, then a scatter through the row
// permutation). A block owns a tile of kLeafTile positions of ``order``; its
// threads list the non-empty leaves whose segment meets the tile (at most
// kLeafTile of them), then the block writes each listed leaf's index to
// ``leaf_id[order[i]]`` for its positions i in the tile. Every position
// belongs to one leaf, so no two writes meet and the list's order does not
// matter. It moves 12 bytes a row (order in, int64 leaf_id out).
//
// Counterpart of lightgbm_tpu/ops/grow.py's while_loop body: cond / body
// (the stop test and the argmax over the leaves' best gains), apply_split
// (the node and leaf arrays, depth, internal_value through
// calculate_leaf_output, the children's sums and monotone windows) and the
// smaller-child choice left_count <= right_count from the split record's
// count channel; then ``hist[large] = hist[parent] - small; hist[small] =
// small``. The plain versions are ops/grow_step.py ``pick`` and
// ``subtract``; each field is equal bit for bit (the same f32 operations,
// built with --fmad=false so that no multiply-add is contracted).
//
// What bounds it: latency. grow_step reads M gains (1 KB at 255 leaves) and
// a few dozen words, in about three dependent round trips to memory; one
// block of 256 threads does the argmax by shuffles, then one thread wires
// the split. hist_subtract moves F * B * 3 floats four times (342 KB at
// 28 x 255), mostly from L2. Both are a launch's worth of time; the design
// only keeps them to one launch each with no host involvement.
//
// The loop stops as the reference's does: at step M - 1, or when the best
// gain is not > 0 (argmax takes the first maximum, as jnp.argmax and
// torch.argmax do). grow_step then clears ctl[kActive], and every kernel of
// a later step returns at once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBig = 1 << 30;
// slots of the loop's control vector (ops/grow_state.py)
constexpr int kActive = 0, kNumLeaves = 1, kStep = 2, kBest = 3, kNew = 4, kSmall = 5,
              kLarge = 6;
// record columns (ops/split.py BEST_F / BEST_I) and row widths of the state
constexpr int kGain = 0, kLG = 1, kLH = 2, kLC = 3, kRG = 4, kRH = 5, kRC = 6, kLO = 7,
              kRO = 8;
constexpr int kBestF = 9, kBestI = 4, kNodeI = 5, kNodeF = 3, kLeafF = 3, kLeafI = 2,
              kLaux = 5;
// positions of ``order`` a leaf_ids block owns
constexpr int kLeafTile = 4096;

struct Params {
  float l1, l2, max_delta_step;
};

// clamp that passes NaN through, like torch.clamp (csrc/split_pair.cu)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  if (l1 == 0.0f) return s;
  const float sgn = isnan(s) ? s : (s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f));
  return sgn * clamp_nan(fabsf(s) - l1, 0.0f, INFINITY);
}

// calculate_leaf_output (ops/split.py), no monotone clamp
__device__ __forceinline__ float leaf_output(float sg, float sh, const Params& p) {
  float ret = -threshold_l1(sg, p.l1) / (sh + p.l2);
  if (p.max_delta_step > 0.0f) ret = clamp_nan(ret, -p.max_delta_step, p.max_delta_step);
  return ret;
}

// (g, i) beats (bg, bi): a larger gain, or the same gain at a smaller leaf
__device__ __forceinline__ bool beats(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

__global__ void __launch_bounds__(kThreads)
pick_kernel(int* __restrict__ ctl, const float* __restrict__ best_f,
            const int* __restrict__ best_i, int* __restrict__ node_i, float* __restrict__ node_f,
            float* __restrict__ leaf_f, int* __restrict__ leaf_i, float* __restrict__ laux,
            const int* __restrict__ mono_a, int M, Params p) {
  __shared__ float red_g[kWarps];
  __shared__ int red_i[kWarps];
  if (!ctl[kActive]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float g = -INFINITY;
  int idx = kBig;
  for (int k = threadIdx.x; k < M; k += kThreads) {
    const float v = best_f[k * kBestF + kGain];
    if (beats(v, k, g, idx)) { g = v; idx = k; }
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float og = __shfl_xor_sync(kFull, g, s);
    const int oi = __shfl_xor_sync(kFull, idx, s);
    if (beats(og, oi, g, idx)) { g = og; idx = oi; }
  }
  if (lane == 0) { red_g[warp] = g; red_i[warp] = idx; }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int w = 1; w < kWarps; ++w) {
    if (beats(red_g[w], red_i[w], g, idx)) { g = red_g[w]; idx = red_i[w]; }
  }
  const int node = ctl[kStep];
  if (!(g > 0.0f) || node >= M - 1) {
    ctl[kActive] = 0;
    return;
  }
  const int best = idx, nl = ctl[kNumLeaves];
  const float* rec = best_f + best * kBestF;
  const int* ri = best_i + best * kBestI;
  const float gain = rec[kGain], lg = rec[kLG], lh = rec[kLH], lc = rec[kLC];
  const float rg = rec[kRG], rh = rec[kRH], rc = rec[kRC], lo = rec[kLO], ro = rec[kRO];
  const int f = ri[0], thr = ri[1], dl = ri[3];
  const int parent = leaf_i[best * kLeafI], depth = leaf_i[best * kLeafI + 1] + 1;
  const float* pa = laux + best * kLaux;
  const float psg = pa[0], psh = pa[1], pnd = pa[2], pmin = pa[3], pmax = pa[4];
  const int mono = mono_a[f];

  // the parent node's child pointer that named the split leaf now names the node
  if (parent >= 0) {
    for (int c = 2; c <= 3; ++c) {
      if (node_i[parent * kNodeI + c] == -(best + 1)) node_i[parent * kNodeI + c] = node;
    }
  }
  int* ni = node_i + node * kNodeI;
  ni[0] = f; ni[1] = thr; ni[2] = -(best + 1); ni[3] = -(nl + 1); ni[4] = dl;
  float* nf = node_f + node * kNodeF;
  nf[0] = gain; nf[1] = leaf_output(psg, psh, p); nf[2] = pnd;
  float* lf = leaf_f + best * kLeafF;
  lf[0] = lo; lf[1] = lc; lf[2] = lh;
  lf = leaf_f + nl * kLeafF;
  lf[0] = ro; lf[1] = rc; lf[2] = rh;
  leaf_i[best * kLeafI] = node; leaf_i[best * kLeafI + 1] = depth;
  leaf_i[nl * kLeafI] = node; leaf_i[nl * kLeafI + 1] = depth;

  // children's sums and monotone windows (serial_tree_learner.cpp:841-850)
  const float mid = (lo + ro) / 2.0f;
  float* la = laux + best * kLaux;
  la[0] = lg; la[1] = lh; la[2] = lc;
  la[3] = mono < 0 ? mid : pmin;
  la[4] = mono > 0 ? mid : pmax;
  la = laux + nl * kLaux;
  la[0] = rg; la[1] = rh; la[2] = rc;
  la[3] = mono > 0 ? mid : pmin;
  la[4] = mono < 0 ? mid : pmax;

  const bool left_smaller = lc <= rc;
  ctl[kBest] = best;
  ctl[kNew] = nl;
  ctl[kSmall] = left_smaller ? best : nl;
  ctl[kLarge] = left_smaller ? nl : best;
  ctl[kNumLeaves] = nl + 1;
  ctl[kStep] = node + 1;
}

// hist[large] = hist[best] - small; hist[small] = small; small = 0 (ready
// for the next step's histogram, which adds into it). The parent's cell is
// read before either write: the smaller or the larger child is the
// parent's own slot.
__global__ void __launch_bounds__(kThreads)
subtract_kernel(const int* __restrict__ ctl, float* __restrict__ hist,
                float* __restrict__ small, long long cells) {
  if (!ctl[kActive]) return;
  const long long best = ctl[kBest], s_idx = ctl[kSmall], l_idx = ctl[kLarge];
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < cells;
       i += (long long)gridDim.x * kThreads) {
    const float pv = hist[best * cells + i];
    const float sv = small[i];
    hist[l_idx * cells + i] = pv - sv;
    hist[s_idx * cells + i] = sv;
    small[i] = 0.0f;
  }
}

// leaf_id[order[i]] = l for every position i of leaf l's segment
// [leaf_begin[l], leaf_begin[l] + leaf_count[l]), l < ctl[kNumLeaves].
__global__ void __launch_bounds__(kThreads)
leaf_id_kernel(const int* __restrict__ ctl, const int* __restrict__ order,
               const int* __restrict__ leaf_begin, const int* __restrict__ leaf_count, int M,
               long long N, long long* __restrict__ leaf_id) {
  __shared__ int listed[kLeafTile];
  __shared__ int n_listed;
  const long long lo = (long long)blockIdx.x * kLeafTile;
  const long long hi = min(lo + kLeafTile, N);
  const int nl = min(ctl[kNumLeaves], M);
  if (threadIdx.x == 0) n_listed = 0;
  __syncthreads();
  for (int l = threadIdx.x; l < nl; l += kThreads) {
    const long long b = leaf_begin[l], e = b + leaf_count[l];
    if (e > b && b < hi && e > lo) listed[atomicAdd(&n_listed, 1)] = l;
  }
  __syncthreads();
  const int n = n_listed;
  for (int j = 0; j < n; ++j) {
    const int l = listed[j];
    const long long b = leaf_begin[l];
    const long long s = max(b, lo), e = min(b + leaf_count[l], hi);
    for (long long i = s + threadIdx.x; i < e; i += kThreads) leaf_id[order[i]] = l;
  }
}

}  // namespace

extern "C" {

// One step's pick and wiring. State (ops/grow_state.py): ctl int32 [16];
// best_f [M, 9] f32 and best_i [M, 4] int32 (each leaf's best split);
// node_i [M, 5] int32 (feature, threshold, left, right, default_left),
// node_f [M, 3] f32 (split_gain, internal_value, internal_count), leaf_f
// [M, 3] f32 (value, count, weight), leaf_i [M, 2] int32 (parent, depth),
// laux [M, 5] f32 (sum_grad, sum_hess, count, monotone min, max); the
// features' monotone [F] int32.
int lgbt_grow_step(void* ctl, const void* best_f, const void* best_i, void* node_i,
                   void* node_f, void* leaf_f, void* leaf_i, void* laux, const void* mono,
                   int M, float l1, float l2, float max_delta_step, void* stream) {
  if (M < 1) return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step};
  pick_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (int*)ctl, (const float*)best_f, (const int*)best_i, (int*)node_i, (float*)node_f,
      (float*)leaf_f, (int*)leaf_i, (float*)laux, (const int*)mono, M, p);
  return (int)cudaGetLastError();
}

// The step's histogram subtraction over hist [M, cells] f32 and the smaller
// child's histogram small [cells] f32, which it leaves zeroed; grid blocks
// of 256 threads.
int lgbt_hist_subtract(const void* ctl, void* hist, void* small, long long cells, int grid,
                       void* stream) {
  if (cells < 1 || grid < 1) return (int)cudaErrorInvalidValue;
  subtract_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ctl, (float*)hist, (float*)small, cells);
  return (int)cudaGetLastError();
}

// Each row's leaf, leaf_id [N] int64, from the loop's segment layout:
// order [N] int32, leaf_begin / leaf_count [M] int32 and ctl[kNumLeaves].
int lgbt_leaf_ids(const void* ctl, const void* order, const void* leaf_begin,
                  const void* leaf_count, int M, long long N, void* leaf_id, void* stream) {
  if (M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (N + kLeafTile - 1) / kLeafTile;
  leaf_id_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)ctl, (const int*)order, (const int*)leaf_begin, (const int*)leaf_count, M, N,
      (long long*)leaf_id);
  return (int)cudaGetLastError();
}

}  // extern "C"
