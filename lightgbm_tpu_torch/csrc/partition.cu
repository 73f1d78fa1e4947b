// One step's pick, tree wiring and stable partition of the device-resident
// split loop for Hopper (sm_90a), in one cooperative launch
// (ops/grow.py run_step).
//
// Counterpart of lightgbm_tpu/ops/grow.py's while_loop cond / body (the
// stop test and the argmax over the leaves' best gains, :1640-1646),
// apply_split (:1277: the node and leaf arrays, depth, internal_value
// through calculate_leaf_output, the children's sums and monotone windows,
// the smaller-child choice left_count <= right_count) and partition_batch
// (:439): the rows order[begin : begin + count] of the picked leaf are
// reordered stably into [left | right] by the split's numerical decision
// (dense_bin.hpp Split: bin <= threshold, the missing bin going to
// default_left), so the segment keeps the reference's [pre | left | right |
// post] layout. Every index and bound is read from device memory and the
// children's (begin, count) are written back there, so no host round trip
// sizes anything. The plain versions are ops/grow_step.py ``pick`` then
// ops/partition.py ``partition``; every field is equal bit for bit (the same
// f32 operations, built with --fmad=false so that no multiply-add is
// contracted; the same stable order).
//
// What bounds it: latency. A split of n rows must read n row indices (4 B)
// and n bins of one feature (1 B, gathered) and write n indices, 9 n bytes:
// 2.7 us at the 1M-row root on 3.35 TB/s, and a fraction of a microsecond at
// the ~35k rows of a typical step, where a chain of dependent trips to
// memory and the launches around them cost more than the bytes. The design
// cuts both: one launch a step where four launched (pick, count, scan,
// scatter), and a single grid barrier in place of three kernel boundaries.
//  1. Every block makes the pick itself: thread k reads leaf k's gain, its
//     split record and its segment bounds, and feature k's meta (kept in
//     shared memory for the first kMetaCap features; beyond them the picked
//     feature's meta is one more trip), in one trip; the argmax (a larger
//     gain, or the same gain at a smaller leaf) leaves every block with the
//     same leaf, the same stop decision, the same (feature, threshold,
//     default_left) and (begin, count). On a stop (the gain not > 0, or
//     M - 1 splits done) block 0 clears ctl[kActive] and every block
//     returns.
//  2. Block b owns the contiguous chunk [b * chunk, (b + 1) * chunk) of the
//     segment, chunk = max(kThreads, ceil(count / grid)), so the first
//     ceil(count / chunk) blocks hold rows and keep them in order. It reads
//     its row ids and their bins once, decides each row with go_left, counts
//     its lefts, and keeps each row with its decision in its top bit, in
//     shared memory, or in scratch[begin + b * chunk ...] when the chunk
//     exceeds kCap rows (segments above grid * kCap rows, 1.35M on an H100).
//  3. One grid barrier, with no atomic: every block publishes its left count
//     and the launch's epoch (bar[0] + 1) in one 64-bit release store to its
//     own word of block_left, and each block with rows polls every block's
//     word (relaxed loads, then one acquire fence) until all carry the
//     epoch; the same loads give it the block totals, which it scans itself.
//     It then ranks its rows by warp ballots in tiles of kTile and writes
//     them straight into order: the left ones after the lefts of earlier
//     blocks, tiles and rows, the right ones after all lefts. Block 0 then
//     writes the children's bounds, the control words and the next epoch.
//     The grid's last block wires the tree (node_i, node_f, leaf_f, leaf_i,
//     laux: arrays no other block reads), at once when it holds no rows, so
//     that the wiring's trips to memory overlap the other blocks' rows.
//
// The invariant that makes the one launch safe: no block writes a ctl slot,
// a leaf bound (leaf_begin / leaf_count), a row of order or the epoch that
// another block of the launch reads before every block has read it. Every
// block reads the epoch, ctl, the gains, the records, every leaf's bounds
// and its segment of order before it arrives at the barrier (the release
// store orders those reads before its arrival), and every block of the grid
// arrives (those without rows arrive and return), so all of those writes
// come after the barrier. The one write before the barrier to a word others
// read is the stop's ctl[kActive] = 0, and a block that reads it returns at
// once, as it would have after its own pick found the same stop. The launch
// is cooperative (cudaLaunchAttributeCooperative) and the grid is at most
// the blocks that fit on the card at once (lgbt_pick_partition_grid), so
// every block is resident and the barrier cannot wait on a block that never
// runs; a grid that does not fit is refused at launch and reported.
//
// Categorical splits (the kCat instantiation, launched when the table has
// categorical features): the picked leaf's membership words (best_b, W =
// ceil(B / 32) a leaf) are read once a block, with the pick's meta, into
// shared memory; a row of a categorical feature then goes left when its
// bin's bit is set (CategoricalDecisionInner, tree.h:275; no default
// direction, lightgbm_tpu/ops/grow.py:284-296): one shared load, a shift
// and a mask a row. The wiring copies the words into the node's row of
// node_b. A numerical-only table runs the kCat = false code.
//
// EFB-bundled tables (the kEfb instantiations, launched when the table's
// bins are the [G, N] groups of lightgbm_tpu/efb.py): the picked feature's
// group row and offset ride in the pick's own loads (thread k reads
// feature k's group and offset with its meta, into shared memory for the
// first kMetaCap features, in room taken from the rows a block stages:
// kEfbCap), the rows are read from the group's row, and
// each bin is decoded to the feature's sub-bin before the decision
// (lightgbm_tpu/ops/grow.py:1298-1301, ``decode_col``: r = bin - off; r +
// (r >= default_bin) where 0 <= r < num_bin - 1, else default_bin), so a
// categorical decision looks up the decoded bin. An unbundled table runs
// the kEfb = false code, unchanged.
//
// Wide bins (the kWide instantiations, for int16 bins of up to 1024 bins a
// feature): the rows' bins are read two bytes each and a categorical split
// carries up to 32 membership words (kMaxWideWords). The byte
// instantiations keep their code. A bundled table's groups are int16 when a
// group holds more than 256 bins (a feature of more than 256 bins in its own
// group, up to 1024: the kEfb and kWide instantiations): the group row is
// read two bytes a row and decoded as the byte one is, the plan's offset in
// 11 bits (kEfb alone: 8).
//
// A histogram pool (the kPool instantiations, ops/grow_state.py): the
// thread that wires the tree also keeps the pool's LRU slots, after
// lightgbm_tpu/ops/grow.py:1479-1536 (HistogramPool::Get): the larger child
// takes the parent's slot when the parent is resident (a hit) and the
// subtraction is on, else the least recently used slot; the smaller child
// the least recently used of the others; their occupants are evicted, any
// other slot still naming a child is freed, and both slots are stamped
// with the step. It writes the slots and the hit into the pool's control
// vector, and the larger child's leaf with "run" = !hit into its first
// slots, which the step's second segment histogram reads as its control
// vector: it builds the larger child only on a miss. One thread does it in
// O(P); no other block of the launch reads the pool.
//
// Forced splits and CEGB (the kExt instantiations, launched when the run
// has a forced-split preamble or coupled CEGB penalties; the others keep
// their code). On a forced step (``forced`` = 1) whose preamble has not
// aborted (ctl[kAbort] 0; split_pair.cu's forced record sets it), every
// block takes the leaf ctl[kFLeaf] and the forced record frec_f / frec_i /
// frec_b in place of the argmax and its record, and does not stop on
// its gain (lightgbm_tpu/ops/grow.py:1625-1637 applies a valid forced split
// whatever the other leaves' gains). Once the preamble has aborted, a forced
// step is a best-gain step: the reference skips the forced splits left and
// then runs its best-gain loop to M - 1 splits, and the host queues K +
// M - 1 steps, so the same splits follow. With coupled penalties
// (feature_used non-null) the wiring thread also marks the split's feature
// paid (lightgbm_tpu/ops/grow.py:1396-1397) and writes ctl[kNewly] = 1 when
// it was not yet, which the penalised all-leaves scan reads (split_pair.cu).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // rows a thread a tile
constexpr int kTile = kThreads * kItems;  // rows a tile
constexpr int kCap = 10240;               // rows a block keeps in shared memory
constexpr int kMetaCap = 1024;            // features whose meta a block keeps in shared memory
constexpr int kEfbCap = kCap - kMetaCap;  // kEfb: rows staged, beside the plan (48 KB static)
constexpr int kMaxWords = 11;             // membership words of a split: ceil(336 / 32)
constexpr int kMaxWideWords = 32;         // kWide: ceil(1024 / 32)
constexpr int kCatBit = 30;               // the categorical flag in a feature's meta word
static_assert(kWarps == 32, "a tile's warp counts are scanned by one warp, kItems a lane");
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kLeftBit = 0x80000000u;
constexpr int kBig = 1 << 30;
constexpr unsigned long long kBarrierNs = 1000000000ull;  // the longest wait at the barrier
// slots of the loop's control vector (ops/grow_state.py)
constexpr int kActive = 0, kNumLeaves = 1, kStep = 2, kBest = 3, kNew = 4, kSmall = 5,
              kLarge = 6, kPBegin = 7, kPCount = 8, kLeft = 9;
constexpr int kFLeaf = 10, kAbort = 11, kNewly = 12;  // forced splits and CEGB (kExt)
constexpr int kMissingZero = 1, kMissingNan = 2;
// the pool's control vector (ops/grow_state.py): the larger child's
// histogram runs (kActive) on its leaf (kSmall), then hit and slots
constexpr int kCtl = 16, kHit = 10, kSSlot = 11, kLSlot = 12, kPSlot = 13;
// record columns (ops/split.py BEST_F / BEST_I) and row widths of the state
constexpr int kGain = 0, kLG = 1, kLH = 2, kLC = 3, kRG = 4, kRH = 5, kRC = 6, kLO = 7,
              kRO = 8;
constexpr int kBestF = 9, kBestI = 4, kNodeI = 5, kNodeF = 3, kLeafF = 3, kLeafI = 2,
              kLaux = 5;
// the block's broadcast words
enum { sActive, sStep, sNumLeaves, sBest, sGo, sF, sThr, sDl, sBegin, sCount, sLeftSmaller,
       sMiss, sDbin, sNanBin, sEpoch, sBefore, sTotal, sTileLeft, sCat, sWords };
constexpr int sForced = sWords;  // kExt: this step takes the forced record

struct Params {
  float l1, l2, max_delta_step;
};

struct Args {
  const uint8_t* bins;
  long long stride_f, stride_n;
  int* order;
  int* scratch;
  int* ctl;
  const float* best_f;
  const int* best_i;
  int* node_i;
  float* node_f;
  float* leaf_f;
  int* leaf_i;
  float* laux;
  const int* missing;
  const int* default_bin;
  const int* num_bin;
  const int* mono;
  int* leaf_begin;
  int* leaf_count;
  unsigned long long* block_left;
  unsigned* bar;
  const int* best_b;            // [M, W] each leaf's best split's membership words (kCat)
  int* node_b;                  // [M - 1, W] each node's (kCat)
  const unsigned char* is_cat;  // [F] (kCat)
  int M, F, W;
  Params p;
  const int* gid;               // [F] each feature's group (kEfb)
  const int* off;               // [F] its offset in the group (kEfb)
  int* pool;                    // kPool: control [kCtl], slot_of [M], slot_leaf [P], slot_age [P]
  int P;                        // kPool: slots
  int subtract;                 // kPool: the subtraction is on (a hit needs it)
  const float* frec_f;          // kExt: the forced record [9], [4], [W]
  const int* frec_i;
  const int* frec_b;
  int forced;                   // kExt: a step of the forced-split preamble
  unsigned char* feature_used;  // kExt: [F] coupled CEGB's paid features (null without)
};

// a bin of the byte or the int16 (kWide) instantiations
template <bool kWide>
using Bin = std::conditional_t<kWide, int16_t, uint8_t>;

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

// kCat: the categorical decision, the bin's bit of the split's words
template <bool kCat>
__device__ __forceinline__ bool go_left(int col, int thr, bool dl, int miss, int dbin,
                                        int nan_bin, bool cat, const int* words) {
  if (kCat && cat) return (words[col >> 5] >> (col & 31)) & 1;
  bool gl = col <= thr;
  if (miss == kMissingZero) {
    if (col == dbin) gl = dl;
  } else if (miss == kMissingNan) {
    if (col == nan_bin) gl = dl;
  }
  return gl;
}

// kEfb: a group bin as feature sub-bin (lightgbm_tpu/efb.py decode_subbin)
__device__ __forceinline__ int decode(int bin, int off, int dbin, int nan_bin) {
  const int r = bin - off;
  return (r >= 0 && r < nan_bin) ? r + (r >= dbin) : dbin;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// A block's word of block_left: the launch's epoch above its left count.
__device__ __forceinline__ void publish(unsigned long long* word, unsigned epoch, int left) {
  const unsigned long long v = ((unsigned long long)epoch << 32) | (unsigned)left;
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(word), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long relaxed(const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
  return v;
}

// Warp 0 of a block with rows: wait until every block of the grid has
// published ``epoch``, and return (lanes alike) the lefts of the blocks
// before block ``b`` and of all blocks. The polls are relaxed loads, all of
// a lane's in flight at once (acquire loads would wait for one another); one
// fence after the last poll makes it an acquire. A wait of more than a
// second cannot happen with every block resident; it traps, so that a fault
// ends the launch with an error instead of holding the card.
__device__ __forceinline__ int2 grid_wait(const unsigned long long* words, int grid, int b,
                                         unsigned epoch, int lane) {
  const unsigned long long t0 = global_ns();
  int before, total;
  for (;;) {
    bool all = true;
    before = 0;
    total = 0;
    for (int k = lane; k < grid; k += 32) {
      const unsigned long long v = relaxed(words + k);
      all &= (unsigned)(v >> 32) == epoch;
      const int left = (int)(unsigned)v;
      total += left;
      if (k < b) before += left;
    }
    if (__all_sync(kFull, all)) break;
    if (global_ns() - t0 > kBarrierNs) __trap();
  }
  asm volatile("fence.acq_rel.gpu;" ::: "memory");
  return make_int2(__reduce_add_sync(kFull, before), __reduce_add_sync(kFull, total));
}

// The tree wiring of split ``best`` at node ``node`` (the new leaf ``nl``),
// as grow_step's pick wrote it, read and written by thread 0 of the grid's
// last block: when that block holds no rows, right after it arrives at the
// barrier, while the others still read theirs, else after its scatter. No
// other block reads these arrays.
template <bool kCat, bool kExt = false>
__device__ __forceinline__ void wire(const Args& a, int best, int nl, int node, int f, int thr,
                                     int dl, const int* words, bool forced = false) {
  float rec[kBestF], pa[kLaux];
  const float* src = a.best_f + best * kBestF;
  if constexpr (kExt) {
    if (forced) src = a.frec_f;
    if (a.feature_used != nullptr) {  // coupled CEGB: the split pays its feature
      a.ctl[kNewly] = a.feature_used[f] ? 0 : 1;
      a.feature_used[f] = 1;
    }
  }
#pragma unroll
  for (int c = 0; c < kBestF; ++c) rec[c] = src[c];
#pragma unroll
  for (int c = 0; c < kLaux; ++c) pa[c] = a.laux[best * kLaux + c];
  const int parent = a.leaf_i[best * kLeafI], depth = a.leaf_i[best * kLeafI + 1] + 1;
  const int mono = a.mono[f];
  // the parent node's child pointer that named the split leaf now names the node
  if (parent >= 0) {
    for (int c = 2; c <= 3; ++c) {
      if (a.node_i[parent * kNodeI + c] == -(best + 1)) a.node_i[parent * kNodeI + c] = node;
    }
  }
  int* ni = a.node_i + node * kNodeI;
  ni[0] = f; ni[1] = thr; ni[2] = -(best + 1); ni[3] = -(nl + 1); ni[4] = dl;
  if (kCat) {
    for (int w = 0; w < a.W; ++w) a.node_b[node * a.W + w] = words[w];
  }
  float* nf = a.node_f + node * kNodeF;
  nf[0] = rec[kGain]; nf[1] = leaf_output(pa[0], pa[1], a.p); nf[2] = pa[2];
  float* lf = a.leaf_f + best * kLeafF;
  lf[0] = rec[kLO]; lf[1] = rec[kLC]; lf[2] = rec[kLH];
  lf = a.leaf_f + nl * kLeafF;
  lf[0] = rec[kRO]; lf[1] = rec[kRC]; lf[2] = rec[kRH];
  a.leaf_i[best * kLeafI] = node; a.leaf_i[best * kLeafI + 1] = depth;
  a.leaf_i[nl * kLeafI] = node; a.leaf_i[nl * kLeafI + 1] = depth;

  // children's sums and monotone windows (serial_tree_learner.cpp:841-850)
  const float mid = (rec[kLO] + rec[kRO]) / 2.0f;
  const float pmin = pa[3], pmax = pa[4];
  float* la = a.laux + best * kLaux;
  la[0] = rec[kLG]; la[1] = rec[kLH]; la[2] = rec[kLC];
  la[3] = mono < 0 ? mid : pmin;
  la[4] = mono > 0 ? mid : pmax;
  la = a.laux + nl * kLaux;
  la[0] = rec[kRG]; la[1] = rec[kRH]; la[2] = rec[kRC];
  la[3] = mono > 0 ? mid : pmin;
  la[4] = mono < 0 ? mid : pmax;
}

// kPool: the pool's LRU update of split ``best`` at node ``node`` (the new
// leaf ``nl``), made by the wiring thread (see the header). Ties go to the
// lowest slot, as jnp.argmin's do.
__device__ __forceinline__ void pool_update(const Args& a, int best, int nl, int node,
                                            bool left_smaller) {
  int* ctl = a.pool;
  int* slot_of = a.pool + kCtl;
  int* slot_leaf = slot_of + a.M;
  int* slot_age = slot_leaf + a.P;
  const int small = left_smaller ? best : nl, large = left_smaller ? nl : best;
  const int pslot = slot_of[best];
  const bool hit = a.subtract && pslot >= 0;
  int lru = 0;
  for (int q = 1; q < a.P; ++q) {
    if (slot_age[q] < slot_age[lru]) lru = q;
  }
  const int lslot = hit ? pslot : lru;
  int sslot = -1;
  for (int q = 0; q < a.P; ++q) {
    if (q != lslot && (sslot < 0 || slot_age[q] < slot_age[sslot])) sslot = q;
  }
  const int occ_l = slot_leaf[lslot], occ_s = slot_leaf[sslot];
  if (occ_l >= 0) slot_of[occ_l] = -1;
  if (occ_s >= 0) slot_of[occ_s] = -1;
  slot_of[small] = sslot;
  slot_of[large] = lslot;
  for (int q = 0; q < a.P; ++q) {
    if (slot_leaf[q] == small || slot_leaf[q] == large) slot_leaf[q] = -1;
  }
  slot_leaf[sslot] = small;
  slot_leaf[lslot] = large;
  slot_age[sslot] = node + 2;  // the root's stamp is 1, a free slot's 0
  slot_age[lslot] = node + 2;
  ctl[kActive] = !hit;
  ctl[kSmall] = large;
  ctl[kHit] = hit;
  ctl[kSSlot] = sslot;
  ctl[kLSlot] = lslot;
  ctl[kPSlot] = pslot;
}

template <bool kCat, bool kEfb, bool kWide, bool kPool, bool kExt>
__global__ void __launch_bounds__(kThreads, 1) pick_partition_kernel(Args a) {
  constexpr int kOffBits = kWide ? 11 : 8;  // kEfb: the offset's bits in a plan word
  __shared__ int stage_s[kEfb ? kEfbCap : kCap];
  __shared__ float red_g[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ int wsum[kWarps];
  __shared__ int woff[kItems * kWarps];
  // missing_type | default_bin << 2 | nan bin << 17 | categorical << kCatBit
  __shared__ int meta_s[kMetaCap];
  __shared__ int sh[sWords + (kExt ? 1 : 0)];
  __shared__ int words_s[kCat ? (kWide ? kMaxWideWords : kMaxWords) : 1];  // the split's words
  __shared__ int plan_s[kEfb ? kMetaCap : 1];    // group << kOffBits | offset (kEfb)
  __shared__ int efb_s[kEfb ? 2 : 1];            // the picked feature's group and offset
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = a.M;

  // ---- 1. the pick, made by every block ----
  // thread k: leaf k's gain, record and bounds, and feature k's meta, in one trip
  float g = -INFINITY;
  int idx = kBig, f = 0, thr = 0, dl = 0, begin = 0, count = 0, lsmall = 0;
  for (int k = tid; k < M; k += kThreads) {
    const float v = a.best_f[k * kBestF + kGain];
    const float lc = a.best_f[k * kBestF + kLC], rc = a.best_f[k * kBestF + kRC];
    const int kf = a.best_i[k * kBestI], kt = a.best_i[k * kBestI + 1];
    const int kd = a.best_i[k * kBestI + 3];
    const int kb = a.leaf_begin[k], kc = a.leaf_count[k];
    if (beats(v, k, g, idx)) {
      g = v; idx = k; f = kf; thr = kt; dl = kd; begin = kb; count = kc; lsmall = lc <= rc;
    }
  }
  for (int k = tid; k < min(a.F, kMetaCap); k += kThreads) {
    meta_s[k] = a.missing[k] | (a.default_bin[k] << 2) | ((a.num_bin[k] - 1) << 17) |
                (kCat && a.is_cat[k] ? 1 << kCatBit : 0);
    if (kEfb) plan_s[k] = (a.gid[k] << kOffBits) | a.off[k];
  }
  if (tid == 0) {
    sh[sActive] = a.ctl[kActive];
    sh[sStep] = a.ctl[kStep];
    sh[sNumLeaves] = a.ctl[kNumLeaves];
    sh[sEpoch] = (int)(a.bar[0] + 1u);
  }
  float wg = g;
  int wi = idx;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float og = __shfl_xor_sync(kFull, wg, s);
    const int oi = __shfl_xor_sync(kFull, wi, s);
    if (beats(og, oi, wg, wi)) { wg = og; wi = oi; }
  }
  if (lane == 0) { red_g[warp] = wg; red_i[warp] = wi; }
  __syncthreads();
  if (warp == 0) {
    wg = red_g[lane];
    wi = red_i[lane];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float og = __shfl_xor_sync(kFull, wg, s);
      const int oi = __shfl_xor_sync(kFull, wi, s);
      if (beats(og, oi, wg, wi)) { wg = og; wi = oi; }
    }
    if (lane == 0) {
      sh[sBest] = wi;
      sh[sGo] = (wg > 0.0f) && sh[sStep] < M - 1;
      if constexpr (kExt) {  // a forced step of a preamble that has not aborted
        sh[sForced] = a.forced && !a.ctl[kAbort];
        if (sh[sForced]) {
          sh[sBest] = a.ctl[kFLeaf];
          sh[sGo] = sh[sStep] < M - 1;
        }
      }
    }
  }
  __syncthreads();
  if (!sh[sActive]) return;
  if (!sh[sGo]) {
    if (blockIdx.x == 0 && tid == 0) {
      a.ctl[kActive] = 0;
      if constexpr (kPool) a.pool[kActive] = 0;  // nor the larger child's histogram
    }
    return;
  }
  const int best = sh[sBest];
  bool holder = idx == best;  // the thread that read the picked leaf (its split's feature >= 0)
  [[maybe_unused]] bool forced = false;
  if constexpr (kExt) {
    forced = sh[sForced] != 0;
    if (forced) {  // thread 0 reads the forced record and the leaf's bounds
      holder = tid == 0;
      if (holder) {
        f = a.frec_i[0]; thr = a.frec_i[1]; dl = a.frec_i[3];
        begin = a.leaf_begin[best]; count = a.leaf_count[best];
        lsmall = a.frec_f[kLC] <= a.frec_f[kRC];
      }
    }
  }
  if (holder) {
    sh[sF] = f; sh[sThr] = thr; sh[sDl] = dl; sh[sBegin] = begin; sh[sCount] = count;
    sh[sLeftSmaller] = lsmall;
    const int mv = f < kMetaCap ? meta_s[f]
        : a.missing[f] | (a.default_bin[f] << 2) | ((a.num_bin[f] - 1) << 17) |
              (kCat && a.is_cat[f] ? 1 << kCatBit : 0);
    sh[sMiss] = mv & 3; sh[sDbin] = (mv >> 2) & 0x7FFF;
    sh[sNanBin] = kCat ? (mv >> 17) & 0x1FFF : mv >> 17;
    if (kCat) sh[sCat] = (mv >> kCatBit) & 1;
    if (kEfb) {
      const int pv = f < kMetaCap ? plan_s[f] : (a.gid[f] << kOffBits) | a.off[f];
      efb_s[0] = pv >> kOffBits;
      efb_s[1] = pv & ((1 << kOffBits) - 1);
    }
  }
  if constexpr (kExt) {
    if (kCat && tid < a.W) words_s[tid] = forced ? a.frec_b[tid] : a.best_b[best * a.W + tid];
  } else {
    if (kCat && tid < a.W) words_s[tid] = a.best_b[best * a.W + tid];
  }
  __syncthreads();
  f = sh[sF]; thr = sh[sThr]; dl = sh[sDl];
  const long long b0 = sh[sBegin];
  const int cnt = sh[sCount];
  const int grid = (int)gridDim.x, b = (int)blockIdx.x;
  const int chunk = max(kThreads, (int)((cnt + (long long)grid - 1) / grid));
  const int nb = max((cnt + chunk - 1) / chunk, 1);  // blocks with rows (block 0 always)
  const unsigned epoch = (unsigned)sh[sEpoch];
  const int node = sh[sStep], nl = sh[sNumLeaves];
  const bool wires = b == grid - 1 && tid == 0;
  if (b >= nb) {
    if (tid == 0) publish(a.block_left + b, epoch, 0);
    if (wires) {
      wire<kCat, kExt>(a, best, nl, node, f, thr, dl, words_s, forced);
      if constexpr (kPool) pool_update(a, best, nl, node, sh[sLeftSmaller] != 0);
    }
    return;
  }
  const int lo = b * chunk;
  const int len = max(min(cnt - lo, chunk), 0);

  // ---- 2. the chunk's rows, decided and staged ----
  const int miss = sh[sMiss], dbin = sh[sDbin], nan_bin = sh[sNanBin];
  const bool cat = kCat && sh[sCat];
  const Bin<kWide>* col =
      reinterpret_cast<const Bin<kWide>*>(a.bins) + (long long)(kEfb ? efb_s[0] : f) * a.stride_f;
  const int eoff = kEfb ? efb_s[1] : 0;
  int* stage = len <= (kEfb ? kEfbCap : kCap) ? stage_s : a.scratch + b0 + lo;
  const int* seg = a.order + b0 + lo;
  int left = 0;
  for (int t = 0; t * kTile < len; ++t) {
    int row[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + tid;
      row[j] = i < len ? seg[i] : 0;
    }
    int bin[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + tid;
      bin[j] = i < len ? (int)col[row[j] * a.stride_n] : 0;
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + tid;
      if (i < len) {
        const int sub = kEfb ? decode(bin[j], eoff, dbin, nan_bin) : bin[j];
        const bool gl = go_left<kCat>(sub, thr, dl != 0, miss, dbin, nan_bin, cat, words_s);
        stage[i] = (int)((unsigned)row[j] | (gl ? kLeftBit : 0u));
        left += gl;
      }
    }
  }
  left = __reduce_add_sync(kFull, left);
  if (lane == 0) wsum[warp] = left;
  __syncthreads();
  if (warp == 0) {
    // ---- 3. the barrier: every block of the grid has read what it needs ----
    int block = wsum[lane];
    block = __reduce_add_sync(kFull, block);
    if (lane == 0) publish(a.block_left + b, epoch, block);
    const int2 lefts = grid_wait(a.block_left, grid, b, epoch, lane);
    if (lane == 0) { sh[sBefore] = lefts.x; sh[sTotal] = lefts.y; }
  }
  __syncthreads();
  const int before = sh[sBefore], total = sh[sTotal];

  // rank by ballots, tile by tile, and write into order in place
  const unsigned lower = (1u << lane) - 1u;
  int* out = a.order + b0;
  int tile_base = before;  // lefts before this tile
  for (int t = 0; t * kTile < len; ++t) {
    unsigned v[kItems];
    int rank[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + tid;
      v[j] = i < len ? (unsigned)stage[i] : 0u;
      const unsigned vote = __ballot_sync(kFull, (v[j] & kLeftBit) != 0u);
      rank[j] = __popc(vote & lower);
      if (lane == 0) woff[j * kWarps + warp] = __popc(vote);
    }
    __syncthreads();
    if (warp == 0) {
      // exclusive scan of the tile's kItems * kWarps warp counts in row
      // order (item-major); lane l takes the kItems entries from l * kItems
      int c[kItems], run = 0;
#pragma unroll
      for (int e = 0; e < kItems; ++e) { c[e] = woff[lane * kItems + e]; run += c[e]; }
      int incl = run;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, s);
        if (lane >= s) incl += o;
      }
      int acc = incl - run;
#pragma unroll
      for (int e = 0; e < kItems; ++e) { woff[lane * kItems + e] = acc; acc += c[e]; }
      if (lane == 31) sh[sTileLeft] = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int i = t * kTile + j * kThreads + tid;
      if (i < len) {
        const int left_before = tile_base + woff[j * kWarps + warp] + rank[j];
        const bool gl = (v[j] & kLeftBit) != 0u;
        const int pos = gl ? left_before : total + (lo + i - left_before);
        out[pos] = (int)(v[j] & ~kLeftBit);
      }
    }
    tile_base += sh[sTileLeft];
    __syncthreads();  // woff and sTileLeft are rewritten by the next tile
  }

  if (wires) {
    wire<kCat, kExt>(a, best, nl, node, f, thr, dl, words_s, forced);
    if constexpr (kPool) pool_update(a, best, nl, node, sh[sLeftSmaller] != 0);
  }
  if (b == 0 && tid == 0) {
    // the children's bounds: leaf best keeps [b0, b0 + left), the new leaf
    // nl takes [b0 + left, b0 + count)
    a.leaf_count[best] = total;
    a.leaf_begin[nl] = (int)b0 + total;
    a.leaf_count[nl] = cnt - total;
    const bool left_smaller = sh[sLeftSmaller] != 0;
    int* ctl = a.ctl;
    ctl[kBest] = best;
    ctl[kNew] = nl;
    ctl[kSmall] = left_smaller ? best : nl;
    ctl[kLarge] = left_smaller ? nl : best;
    ctl[kNumLeaves] = nl + 1;
    ctl[kStep] = node + 1;
    ctl[kPBegin] = (int)b0;
    ctl[kPCount] = cnt;
    ctl[kLeft] = total;
    a.bar[0] = epoch;
  }
}

// The instantiation of a launch: categorical (bit 0 of ``kind``), bundled
// (bit 1), int16 bins (bit 2), a histogram pool (bit 3) and forced splits or
// coupled CEGB (bit 4).
using Kernel = decltype(&pick_partition_kernel<false, false, false, false, false>);

template <bool kPool, bool kExt>
Kernel instantiation_of(int kind) {
  switch (kind & 7) {
    case 1: return &pick_partition_kernel<true, false, false, kPool, kExt>;
    case 2: return &pick_partition_kernel<false, true, false, kPool, kExt>;
    case 3: return &pick_partition_kernel<true, true, false, kPool, kExt>;
    case 4: return &pick_partition_kernel<false, false, true, kPool, kExt>;
    case 5: return &pick_partition_kernel<true, false, true, kPool, kExt>;
    case 6: return &pick_partition_kernel<false, true, true, kPool, kExt>;
    case 7: return &pick_partition_kernel<true, true, true, kPool, kExt>;
    default: return &pick_partition_kernel<false, false, false, kPool, kExt>;
  }
}

Kernel instantiation(int kind) {
  if (kind & 16) {
    return (kind & 8) ? instantiation_of<true, true>(kind) : instantiation_of<false, true>(kind);
  }
  return (kind & 8) ? instantiation_of<true, false>(kind) : instantiation_of<false, false>(kind);
}

}  // namespace

extern "C" {

// The blocks of lgbt_pick_partition's grid for the instantiation ``kind``
// (bit 0: categorical, bit 1: bundled, bit 2: int16 bins, bit 3: a
// histogram pool, bit 4: forced splits or coupled CEGB; an instantiation
// that does not exist is refused): as many as fit on the current
// device at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor times the
// SM count), so that a cooperative launch of them is never refused.
int lgbt_pick_partition_grid(int* grid, int kind) {
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  *grid = 0;
  if (instantiation(kind) == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, instantiation(kind), kThreads, 0);
  *grid = per_sm * sms;
  return (int)err;
}

// One step of the split loop: the pick and tree wiring of the leaf with the
// largest best gain, and the stable partition of its segment of order [N]
// int32. State (ops/grow_state.py): ctl int32 [16]; best_f [M, 9] f32 and
// best_i [M, 4] int32 (each leaf's best split); node_i [M, 5] int32, node_f
// [M, 3] f32, leaf_f [M, 3] f32, leaf_i [M, 2] int32, laux [M, 5] f32;
// leaf_begin / leaf_count [M] int32; the F features' missing_type /
// default_bin / num_bin / monotone [F] int32; the bins of feature f at
// bins + f * stride_f + row * stride_n. Scratch: scratch [N] int32 (a
// chunk's staged rows above kCap), block_left [grid] int64 (each block's
// epoch and left count), bar [1] uint32 (the epoch of the last launch that
// split, 0 before the first). With categorical features, is_cat [F] bytes,
// best_b [M, W] and node_b [M - 1, W] int32 (W = ceil(B / 32) membership
// words; is_cat null without them). An EFB-bundled table: gid / off [F]
// int32 (each feature's group and offset; null unbundled), the bins of
// feature f's group at bins + gid[f] * stride_f. grid blocks of 1024
// threads, at most lgbt_pick_partition_grid's for the instantiation,
// launched cooperatively; the launch's error is returned. Does nothing
// once ctl[0] is 0. int16 bins: bin_bytes 2, W <= 32 (a bundled table's
// groups too). A histogram pool: pool [16 + M + 2 P] int32 (its
// control vector, slot_of, slot_leaf, slot_age; null without one), P slots,
// subtract 0 to build both children of every split. ext 1 launches the
// kExt instantiation: a forced step (forced 1) takes the leaf ctl[10] and
// the record frec_f [9] f32, frec_i [4] int32, frec_b [W] int32 unless
// ctl[11] is set; feature_used [F] bytes (coupled CEGB, else null) is
// marked at the split's feature and ctl[12] says whether it was new.
int lgbt_pick_partition(const void* bins, long long stride_f, long long stride_n, void* order,
                        void* scratch, void* ctl, const void* best_f, const void* best_i,
                        void* node_i, void* node_f, void* leaf_f, void* leaf_i, void* laux,
                        const void* missing, const void* default_bin, const void* num_bin,
                        const void* mono, void* leaf_begin, void* leaf_count, void* block_left,
                        void* bar, const void* best_b, void* node_b, const void* is_cat,
                        const void* gid, const void* off, void* pool, int P, int subtract,
                        int bin_bytes, int M, int F, int W, float l1, float l2,
                        float max_delta_step, int grid, int ext, const void* frec_f,
                        const void* frec_i, const void* frec_b, int forced, void* feature_used,
                        void* stream) {
  if (M < 1 || F < 1 || grid < 1 || (bin_bytes != 1 && bin_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const bool wide = bin_bytes == 2;
  if (is_cat != nullptr && (best_b == nullptr || node_b == nullptr || W < 1 ||
                            W > (wide ? kMaxWideWords : kMaxWords)))
    return (int)cudaErrorInvalidValue;
  if ((gid == nullptr) != (off == nullptr)) return (int)cudaErrorInvalidValue;
  if (pool != nullptr && (P < 2 || P > M)) return (int)cudaErrorInvalidValue;
  if (ext && (frec_f == nullptr || frec_i == nullptr || (is_cat != nullptr && frec_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!ext && (forced || feature_used != nullptr)) return (int)cudaErrorInvalidValue;
  const int kind = (is_cat != nullptr ? 1 : 0) | (gid != nullptr ? 2 : 0) | (wide ? 4 : 0) |
                   (pool != nullptr ? 8 : 0) | (ext ? 16 : 0);
  const Kernel kern = instantiation(kind);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  Args a{(const uint8_t*)bins, stride_f, stride_n, (int*)order, (int*)scratch, (int*)ctl,
         (const float*)best_f, (const int*)best_i, (int*)node_i, (float*)node_f,
         (float*)leaf_f, (int*)leaf_i, (float*)laux, (const int*)missing,
         (const int*)default_bin, (const int*)num_bin, (const int*)mono, (int*)leaf_begin,
         (int*)leaf_count, (unsigned long long*)block_left, (unsigned*)bar, (const int*)best_b,
         (int*)node_b, (const unsigned char*)is_cat, M, F, W, Params{l1, l2, max_delta_step},
         (const int*)gid, (const int*)off, (int*)pool, P, subtract, (const float*)frec_f,
         (const int*)frec_i, (const int*)frec_b, forced, (unsigned char*)feature_used};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // extern "C"
