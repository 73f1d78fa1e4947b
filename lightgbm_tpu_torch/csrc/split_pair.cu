// Two-child best-split scan for Hopper (sm_90a), one launch a call.
//
// Replaces the TPU kernel lightgbm_tpu/ops/split_pallas.py:
// find_best_split_pair_pallas (body _kernel): the best numerical split of
// each child of a split, with the missing-value scan directions, kEpsilon
// seeds, L1/L2/max_delta_step, the monotone clamp, the feature mask and the
// reference tie-breaks, in the output layout of lightgbm_tpu/ops/grow.py
// _BEST_F ([C, 9] f32) plus [C, 4] int32 (feature, threshold, num_cat,
// default_left). The formulas are those of lightgbm_tpu/ops/split.py
// (candidate_gains and its helpers) and of the port's plain version,
// lightgbm_tpu_torch/ops/split.py, op for op.
//
// What bounds it on the card: latency, not bytes. One call reads C*F*B*3
// floats (171 KB for two children at 28 x 255, 0.05 us at 3.35 TB/s) and
// does a few thousand operations per feature; what it costs is launches and
// chains of dependent steps. The design cuts both:
//  - Rows by leaf index. Block (f, c) reads feature f of leaf leaf_c
//    straight from the grower's [M, F, B, 3] histograms, so the caller
//    makes no contiguous copy of the children (a kernel of its own).
//  - One round trip to device memory before the fold: the row, the
//    feature's meta, the child's sums and window are loaded at once, and
//    the row is staged into shared memory channel-major, its excluded bins
//    zeroed.
//  - The bin prefix in order without waiting on memory. It must stay a
//    left fold in f32 (the CPU fold order of ops/split.py _bin_prefix, so
//    the sums match the plain version bit for bit), so its floor is a
//    chain of B dependent adds. Lanes 0-2 of warp 0 fold one channel each
//    over batches of 8 bins, a batch two 16-byte shared loads issued one
//    batch ahead of its 8 adds (software pipelined, registers indexed only
//    at compile time, so none spills), its prefixes stored after them. No
//    load of the fold reads what a store of the fold wrote, and the padded
//    rows need no guards.
//  - Argmax by warp shuffles: 5 xor rounds per direction inside each warp,
//    then warp 0 reduces the 8 warps' winners in 3 rounds after one
//    barrier, with the reference tie-breaks (dir -1 keeps the largest
//    threshold among equal gains, dir +1 the smallest).
//  - The feature argmax in the same launch. Each block writes its
//    feature's record, fences, and takes a ticket from count[c]; the block
//    that draws ticket F - 1 is the last of its child. It reads the F
//    records (from L2), each thread keeping the whole record of its best,
//    takes the smallest index among equal gains, and the thread holding the
//    winner writes the child's split record and sets count[c] back to 0.
//    Which block comes last does not change the result. count persists
//    between calls, so calls that share it must run in order: every caller
//    in the port launches on the device's one current stream.
//
// The device-indexed entry (lgbt_split_pair_dev, split_pair_kernel<true, *>)
// serves the device-resident split loop: it reads the two children's leaf
// indices from the loop's control vector, their sums and monotone windows
// from laux and their depth from leaf_i, applies the max_depth gate, and
// writes the records straight into the loop's best_f / best_i rows. Once
// the loop has stopped, every block returns before it draws a ticket, so
// the counters stay 0.
//
// The folded entry (split_pair_kernel<true, true>, a step's scan) also does
// the histogram subtraction trick (serial_tree_learner.cpp:510; after
// lightgbm_tpu/ops/grow.py:1421-1426 apply_split's smaller-child choice),
// which was a launch of its own: hist[large] = hist[best] - small and
// hist[small] = small, with ``small`` the step's histogram of the smaller
// child in a scratch buffer. Its output has one reader, this scan, which
// already reads both children's rows, so the subtraction happens where the
// rows are read: one launch a step fewer and the rows read once. The
// parent's slot ctl[kBest] is one of the children's (the left child keeps
// it, and either child can be the smaller), so a block that wrote a child's
// row could race with the block that still reads the parent's. The design:
//  - The block of the larger child for feature f is the only block that
//    reads hist[best][f] and the only one that writes hist[.][f]: it loads
//    the parent's row and the scratch row, subtracts (one f32 sub, as the
//    plain version), writes both children's rows of its feature, and scans
//    the difference. Each thread reads its cells before it writes them.
//  - The smaller child's block only reads the scratch row and scans it.
//    Neither block may clear the scratch, which both read. Two scratch
//    buffers alternate by step parity (the steps are unrolled on the host):
//    step k's histogram writes small[k % 2], and step k's scan clears
//    small[(k + 1) % 2] (the smaller child's block, its feature's row),
//    which step k + 1's histogram adds into and whose last readers, step
//    k - 1's scan, finished a launch earlier.
// A step's scan now moves 5 * F * B * 3 floats where it read 2 (the
// parent's row and the scratch read, three rows written: 428 KB at 28 x
// 255, 0.13 us at 3.35 TB/s, mostly in L2), its loads issued with the
// block's other loads.
// The root's scan (C = 1) has no subtraction and keeps the plain entry.
//
// Categorical features (the kCat instantiations, launched when the table
// has any; a numerical-only table runs the kCat = false code as before).
// The TPU kernel declines categorical metas (split_pallas.py:289-290), so
// the reference scans them in XLA (lightgbm_tpu/ops/split.py:325-468); the
// formulas and their order are its, and the port's plain version's
// (ops/split.py categorical_candidates). Block (f, c) owns one feature of
// one child, so the branch is uniform across the block, and a categorical
// block reads the same row (the subtracted one, in the folded entry) as a
// numerical one, unfolded:
//  - one-hot (num_bin <= max_cat_to_onehot): thread t scores the split of
//    bin t against the rest, and the block's argmax keeps the smallest bin
//    among equal gains;
//  - CTR: each valid bin's key sum_grad / (sum_hess + cat_smooth) (an
//    invalid bin's +inf), its rank counted by one thread a bin over the
//    feature's bins (key_j < key_b, or equal at j < b: IEEE compares, so
//    -0.0 and 0.0 tie as in a stable sort), the bins scattered into sorted
//    order; six lanes of warp 0 fold the three channels in both
//    directions (the left folds of the plain version, in its order), two
//    lanes run the min_data_per_group grouping (sequential by nature: the
//    count resets only where a candidate is emitted), and every thread
//    scores its candidates of both directions, the first maximum of
//    [forward, reverse] winning.
// What bounds a categorical block is its chains: the rank is B compares a
// thread, the folds and the grouping B dependent steps each, about
// 3 * num_bin dependent shared-memory steps for a CTR feature.
// Every block of a kCat launch writes its membership words (a numerical
// feature's: the one-hot of its threshold) beside its record, and the
// child's last block copies the winner's words into the record's row.
//
// Wide bins (the kWide instantiations, launched for 336 < B <= 1024): the
// same code over rows of up to 1024 bins. The fold's chain grows with B (a
// chain of B dependent adds a channel), and a categorical block's arrays
// (CatSmem) come to 35 KB beside the 12.7 KB prefix rows, under the 48 KB
// of static shared memory with the ranks kept in 16 bits. The TPU kernel
// stops at B = 336 (its radix histogram's cap); the reference scans wider
// rows in XLA.
//
// A histogram pool (the kPool instantiations of the folded entry: the
// hist buffer holds P < M slots, ops/grow_state.py): the rows are slots,
// not leaves. The step's pick_partition left the slots in the pool's
// control vector: the parent's (kPSlot), the smaller and the larger
// child's (kSSlot, kLSlot) and whether the parent was resident (kHit). On
// a hit the larger child's block subtracts as above from the parent's slot,
// which the larger child takes over; on a miss it reads the larger child's
// own histogram, built by a second segment launch into ``large``, and
// clears the other ``large`` scratch for the next step. The root's scan
// reads slot 0, the root's.
//
// CEGB penalties (the kPen instantiations of the root's and the folded
// entry, lgbt_split_pair_cegb; after lightgbm_tpu/ops/grow.py:1010-1020
// leaf_penalties and lightgbm_tpu/ops/split.py:649-653): the block of
// feature f of leaf l computes the feature's penalty itself,
//   split * count(l) + coupled[f] * !feature_used[f] + lazy[f] * unused[l, f]
// (split = tradeoff * penalty_split, coupled and lazy already times the
// tradeoff, f32, in that order of operations), and subtracts it from the
// feature's best gain before the argmax over features, so the record's gain
// is the penalised one. The count is laux's, the leaf's bagged rows.
//
// The all-leaves entry (the same kPen instantiation of the root's entry,
// grid (F, M), block (f, l) scanning leaf l): the reference re-ranks every
// leaf after every split under the new penalties (rescan_all,
// lightgbm_tpu/ops/grow.py:1022-1047). A leaf's record depends on its
// histogram, its laux row, its depth, feature_used and its unused row.
// A split of leaf b on feature f changes only the two children's rows of
// those (which the folded entry rescans) and, with coupled penalties,
// feature_used[f]: the split pays f. Lazy counts move only for the
// children (the rows that paid are the children's), and the split penalty
// is each leaf's own count. So every other leaf's inputs change only at a
// first payment of a coupled feature, and feature_used persists across
// trees: at most F steps of a whole training. The entry therefore returns
// at once (every block, before any ticket) unless the step's pick wrote
// ctl[kNewly] = 1, and rescans then every leaf below ctl[kNumLeaves] but
// the two children; its records then equal rescan_all's. Blocks of leaves
// >= num_leaves return at once. Its tickets are one a leaf (count [M]) and
// its per-feature records [M, F, .] scratch of their own.
//
// CEGB under a histogram pool (the pooled all-leaves entry: kPen and kPool
// without kFold). A pooled step's folded scan is the pool's, unpenalised:
// it folds the children's rows into their slots and writes records that
// this entry then replaces. The entry follows the reference's pooled
// rescan (rescan_resident, lightgbm_tpu/ops/grow.py:1049-1108): a leaf
// evicted from the pool has no histogram to rescan, so the reference
// rescans the resident slots only, and patches each other leaf's cached
// record: its gain takes back the coupled penalty of the feature the step
// paid, when that record's feature is the paid one (Split,
// serial_tree_learner.cpp:757-775). The grid is (F, P), block (f, p)
// scanning slot p's row for its leaf slot_leaf[p] (a stamped slot, below
// ctl[kNumLeaves]) under the penalties: the step's two children at every
// step, whatever the penalties (with a split or lazy penalty alone the
// launch scans them and nothing else), any other resident leaf only when
// the step's pick wrote ctl[kNewly] (coupled penalties only; a resident
// leaf's record changes only then). At such a
// step block (0, 0) first patches the evicted leaves (slot_of -1, a record
// on the step's feature node_i[ctl[kStep] - 1] with a gain above -inf:
// gain + coupled[f], one f32 add): they are rows no other block of the
// launch writes. Its tickets and scratch are the unpooled entry's, by
// slot. (A penalised pooled folded scan, which would save the children's
// second scan, spilled registers in its categorical instantiation.)
//
// The forced record (forced_record_kernel, lgbt_forced_record; a step of
// the forced-split preamble, lightgbm_tpu/ops/grow.py:1600-1637): one
// block computes gather_info_for_threshold (lightgbm_tpu/ops/split.py:
// 519-600) for the step's (leaf, feature, threshold) from the forced table
// [K, 3], reading the feature's row of the leaf's histogram (its pool slot
// under a pool). Its threads stage the row in shared memory, three lanes
// fold one channel each over the right side's bins in bin order (the plain
// version's left fold), and thread 0 writes the record (gain, sums, the
// unconstrained outputs; feature, threshold, num_cat, default_left; the
// one-hot membership words) where the step's pick reads it, and the leaf
// into ctl[kFLeaf]. A record whose gain is -inf, or a leaf at max_depth,
// sets ctl[kAbort] instead: the pick then takes the argmax, and every later
// forced record returns at once. What bounds it is the fold's chain of
// num_bin dependent adds (a few microseconds); it moves B * 12 bytes.
//
// Built with --fmad=false: a contracted a*b+c rounds once where the plain
// version rounds twice, which moves gains by an ulp and flips near-ties.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 8;  // bins a fold lane loads ahead of its adds
// The row sizes of the byte-width (B <= 336) and the wide (B <= 1024)
// instantiations: kMaxBins, the row floats a thread stages (kStage), and
// kRow, the floats of one channel's prefix row in shared memory: B bins,
// two batches of padding the fold may touch, and 4 (20) more so that the
// three rows start 16 bytes apart modulo the 128 bytes of the banks (1424 =
// 11 * 128 + 16; 4240 = 33 * 128 + 16)
template <bool kWide>
struct Dims {
  static constexpr int kMaxBins = kWide ? 1024 : 336;
  static constexpr int kStage = (kMaxBins * 3 + kThreads - 1) / kThreads;
  static constexpr int kRow = kMaxBins + 2 * kBatch + (kWide ? 20 : 4);
};
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
// K_EPSILON = 1e-15 (meta.h:42) as the plain version rounds it into f32
constexpr double kEpsilon = 1e-15;

struct Params {
  float l1, l2, max_delta_step, min_data, min_hess, min_gain;
};

// The categorical scan's knobs and buffers (kCat).
struct Cat {
  const unsigned char* is_cat;  // [F]
  int* feat_b;                  // [C, F, W] each feature's membership words
  int* outb;                    // [rows, W] each record's membership words
  int W;
  int max_onehot, max_threshold;  // max_cat_to_onehot, max_cat_threshold
  float smooth, l2, min_group;    // cat_smooth, lambda_l2 + cat_l2, min_data_per_group
};

// A categorical block's shared memory (kCat only); the wide block keeps
// its ranks in 16 bits to stay under 48 KB of static shared memory.
template <bool kWide>
struct CatSmem {
  using Rank = std::conditional_t<kWide, int16_t, int>;
  static constexpr int kMaxBins = Dims<kWide>::kMaxBins;
  float key[kMaxBins];           // the CTR sort key of each bin
  Rank rank[kMaxBins];           // each bin's position in sorted order
  Rank sorted[kMaxBins];         // the bin at each position
  unsigned char valid[kMaxBins];
  float pref[2][3][kMaxBins];    // [direction][channel][position] left folds
  unsigned char emit[2][kMaxBins];
};

// The block's record, published by thread 0 (kCat): (gain, left_g, left_h
// incl. eps, left_c), (threshold, code) with code = default_left | num_cat
// << 1 | use_ctr << 16, and how its words are made: mode 0 the one-hot of
// t, 1 / 2 the CTR bins ranked <= t / >= used - 1 - t.
struct CatRec {
  float4 f;
  int t, code, mode, used;
};

// clamp that passes NaN through, like torch.clamp and jnp.clip (fminf and
// fmaxf would drop it)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float threshold_l1(float s, float l1) {
  if (l1 == 0.0f) return s;
  const float sgn = isnan(s) ? s : (s > 0.0f ? 1.0f : (s < 0.0f ? -1.0f : 0.0f));
  return sgn * clamp_nan(fabsf(s) - l1, 0.0f, INFINITY);
}

__device__ __forceinline__ float leaf_output(float sg, float sh, const Params& p) {
  float ret = -threshold_l1(sg, p.l1) / (sh + p.l2);
  if (p.max_delta_step > 0.0f) {
    ret = clamp_nan(ret, -p.max_delta_step, p.max_delta_step);
  }
  return ret;
}

__device__ __forceinline__ float leaf_output_constrained(float sg, float sh, const Params& p,
                                                         float lo, float hi) {
  return clamp_nan(leaf_output(sg, sh, p), lo, hi);
}

__device__ __forceinline__ float gain_given_output(float sg, float sh, float out,
                                                   const Params& p) {
  const float sg_l1 = threshold_l1(sg, p.l1);
  return -(2.0f * sg_l1 * out + (sh + p.l2) * out * out);
}

__device__ __forceinline__ float min_gain_shift(float sg, float sh, const Params& p) {
  const float sh_eff = sh + (float)(2.0 * kEpsilon);
  const float out = leaf_output(sg, sh_eff, p);
  return gain_given_output(sg, sh_eff, out, p) + p.min_gain;
}

__device__ __forceinline__ float candidate_gain(float lg, float lh, float rg, float rh,
                                                float lc, float rc, bool valid, int mono,
                                                float min_c, float max_c, float mgs,
                                                const Params& p) {
  bool ok = valid && lc >= p.min_data && rc >= p.min_data && lh >= p.min_hess &&
            rh >= p.min_hess;
  const float lo = leaf_output_constrained(lg, lh, p, min_c, max_c);
  const float ro = leaf_output_constrained(rg, rh, p, min_c, max_c);
  float g = gain_given_output(lg, lh, lo, p) + gain_given_output(rg, rh, ro, p);
  if ((mono > 0 && lo > ro) || (mono < 0 && lo < ro)) g = 0.0f;
  ok = ok && g > mgs;
  return ok ? g : -INFINITY;
}

// (g, t) beats (best_g, best_t): a larger gain, or an equal gain at the
// threshold the direction prefers (the largest for dir -1, the smallest for
// dir +1; the smallest feature index in the pick). Gains are never NaN.
template <bool kLargest>
__device__ __forceinline__ bool beats(float g, int t, float best_g, int best_t) {
  return g > best_g || (g == best_g && (kLargest ? t > best_t : t < best_t));
}

// Argmax over the lanes of each group of kLanes (lane 0 of the group ends
// with it), by xor shuffles.
template <bool kLargest, int kLanes = 32>
__device__ __forceinline__ void warp_argmax(float& g, int& t) {
#pragma unroll
  for (int s = kLanes / 2; s > 0; s >>= 1) {
    const float og = __shfl_xor_sync(kFull, g, s);
    const int ot = __shfl_xor_sync(kFull, t, s);
    if (beats<kLargest>(og, ot, g, t)) { g = og; t = ot; }
  }
}

// carry += v.x, v.x = carry, ... for the four lanes of v, in order
__device__ __forceinline__ void fold4(float4& v, float& carry) {
  carry = carry + v.x; v.x = carry;
  carry = carry + v.y; v.y = carry;
  carry = carry + v.z; v.z = carry;
  carry = carry + v.w; v.w = carry;
}

// Inclusive prefix of one channel's row (16-byte aligned) for b < B, in bin
// order, a batch of 8 bins at a time as two 16-byte words: batch i + 1's
// loads go out before batch i's adds, and batch i's prefixes are stored
// after them. The row is padded by two batches, so no load or store needs
// a guard (what the fold leaves past B is never read).
__device__ __forceinline__ void fold_channel(float* row, int B) {
  float4* r = reinterpret_cast<float4*>(row);
  float4 a = r[0], b = r[1];
  float carry = 0.0f;
  for (int q = 0; q < (B + 3) / 4; q += 2) {
    const float4 na = r[q + 2], nb = r[q + 3];
    fold4(a, carry);
    fold4(b, carry);
    r[q] = a;
    r[q + 1] = b;
    a = na;
    b = nb;
  }
}

// Where the device-indexed entry (kDev) reads its leaves and writes its
// records: the split loop's state (ops/grow_state.py).
struct LoopState {
  const int* ctl;        // control vector: [kActive] the loop runs, [kBest] / [kNew] the children
  const float* laux;     // [M, 5] per leaf: sum_grad, sum_hess, count, monotone min, max
  const int* leaf_i;     // [M, 2] per leaf: parent, depth
  int max_depth;         // <= 0: no limit
  const float* small;    // kFold: [F, B, 3] the smaller child's histogram (this step's scratch)
  float* zero;           // kFold: [F, B, 3] the other scratch, cleared for the next step
  const int* pool;       // kPool: the pool's control vector (ops/grow_state.py)
  const float* large;    // kPool: [F, B, 3] the larger child's histogram on a miss
  float* large_zero;     // kPool: [F, B, 3] the other one, cleared for the next step
};
constexpr int kActive = 0, kBest = 3, kNew = 4, kSmall = 5;  // control slots
constexpr int kNumLeaves = 1, kStep = 2, kFLeaf = 10, kAbort = 11, kNewly = 12;

// CEGB (kPen): the penalty vectors and the training's state
// (ops/grow_state.py Cegb); a null vector is a penalty not given.
struct Pen {
  const unsigned char* feature_used;  // [F] (coupled)
  const float* unused;                // [M, F] bagged rows of each leaf not yet paid (lazy)
  const float* coupled;               // [F] tradeoff * coupled
  const float* lazy;                  // [F] tradeoff * lazy
  float split;                        // tradeoff * penalty_split
  int all;                            // the all-leaves entry: block (f, l) scans leaf l
  const int* slot_of;                 // kPool all-leaves: [M] each leaf's slot, -1 evicted
  const int* slot_leaf;               // [P] each slot's leaf, -1 free
  const int* slot_age;                // [P] each slot's stamp, 0 never used
  const int* node_i;                  // [M, 5] the tree's nodes (the step's split feature)
};

// The CEGB penalty of feature f at leaf ``leaf`` of ``count`` bagged rows,
// in the reference's order of f32 operations.
__device__ __forceinline__ float cegb_penalty(const Pen& pen, int leaf, int f, int F,
                                              float count) {
  float v = pen.split * count;
  if (pen.coupled != nullptr) v = v + pen.coupled[f] * (pen.feature_used[f] ? 0.0f : 1.0f);
  if (pen.lazy != nullptr) v = v + pen.lazy[f] * pen.unused[(long long)leaf * F + f];
  return v;
}
constexpr int kHit = 10, kSSlot = 11, kLSlot = 12, kPSlot = 13;  // the pool's control slots

// The pooled all-leaves entry's patch of the evicted leaves' cached records
// (see the header), by one block: a gain on the step's paid feature takes
// back its coupled penalty.
__device__ __forceinline__ void patch_evicted(const Pen& pen, const int* ctl, float* outf,
                                              const int* outi) {
  const int nl = ctl[kNumLeaves];
  const int fs = pen.node_i[(ctl[kStep] - 1) * 5];
  const float add = pen.coupled[fs];
  for (int l = threadIdx.x; l < nl; l += kThreads) {
    if (pen.slot_of[l] < 0 && outi[l * 4] == fs && outf[l * 9] > -INFINITY)
      outf[l * 9] = outf[l * 9] + add;
  }
}

// One block per (feature, child). feat_f[c, f, :] = (gain, left_g, left_h
// incl. eps, left_c) and feat_i[c, f, :] = (t, default_left) of the
// feature's best threshold; the last block of child c writes outf[c] and
// outi[c] from them. kDev: child c is leaf ctl[kBest] (c = 0) or ctl[kNew]
// (c = 1), its sums and window come from laux, its record goes to row
// leaf of outf [M, 9] / outi [M, 4] with the gain -inf at a depth >=
// max_depth (the max_depth gate of ops/grow.py), and once ctl[kActive] is
// 0 every block returns before it draws a ticket, so count stays 0. kFold
// (with kDev, C = 2): the rows come from hist[ctl[kBest]] and ls.small as
// the header says, and hist's children's rows and ls.zero are written.
// The best categorical split of the block's feature (every thread
// enters; the row is staged raw in pre): its record in r, published by
// the caller.
template <bool kWide>
__device__ __forceinline__ void categorical_scan(const float* pre, CatSmem<kWide>& cs, CatRec& r,
                                                 float* red_g, int* red_t, int B, int num_bin,
                                                 int miss, float sg, float sh, float nd,
                                                 float min_c, float max_c, float mgs,
                                                 const Params& p, const Cat& cat) {
  constexpr int kMaxBins = Dims<kWide>::kMaxBins, kRow = Dims<kWide>::kRow;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float eps = (float)kEpsilon;
  const int used_bin = num_bin - (miss != 0 ? 1 : 0);
  float bg = -INFINITY;
  int bt = kBig;
  if (num_bin <= cat.max_onehot) {
    // one-hot: the left side is bin t, the right side sum_hess_eff's rest
    const float sh_eff = sh + (float)(2.0 * kEpsilon);
    for (int t = tid; t < B; t += kThreads) {
      const float lg = pre[t], lh_raw = pre[kRow + t], lc = pre[2 * kRow + t];
      const float lh = lh_raw + eps;
      const float rg = sg - lg, rh = sh_eff - lh, rc = nd - lc;
      bool ok = t < used_bin && lc >= p.min_data && rc >= p.min_data &&
                lh_raw >= p.min_hess && rh >= p.min_hess;
      const float lo = leaf_output_constrained(lg, lh, p, min_c, max_c);
      const float ro = leaf_output_constrained(rg, rh, p, min_c, max_c);
      const float g = gain_given_output(lg, lh, lo, p) + gain_given_output(rg, rh, ro, p);
      ok = ok && g > mgs;
      if (beats<false>(ok ? g : -INFINITY, t, bg, bt)) { bg = ok ? g : -INFINITY; bt = t; }
    }
  } else {
    // CTR: keys, the count of valid bins, ranks and the sorted order
    int used = 0;
    for (int b0 = 0; b0 < B; b0 += kThreads) {
      const int b = b0 + tid;
      bool v = false;
      if (b < B) {
        const float cnt = pre[2 * kRow + b];
        v = b < used_bin && cnt >= cat.smooth;
        cs.key[b] = v ? pre[b] / (pre[kRow + b] + cat.smooth) : INFINITY;
        cs.valid[b] = v;
      }
      used += __syncthreads_count(v);
    }
    for (int b = tid; b < num_bin; b += kThreads) {
      const float kb = cs.key[b];
      int rk = 0;
      for (int j = 0; j < num_bin; ++j) {
        const float kj = cs.key[j];
        rk += (kj < kb) || (kj == kb && j < b);
      }
      cs.rank[b] = rk;
      cs.sorted[rk] = b;
    }
    __syncthreads();
    // the left folds of both directions, a lane a (direction, channel);
    // position 0 is folded even with no valid bin, as the plain version's
    const int npos = max(used, 1);
    if (tid < 6) {
      const int d = tid / 3, ch = tid - 3 * d;
      float carry = 0.0f;
      for (int i = 0; i < npos; ++i) {
        const int pos = d == 0 ? i : max(used - 1 - i, 0);
        carry = carry + pre[ch * kRow + cs.sorted[pos]];
        cs.pref[d][ch][i] = carry;
      }
    }
    __syncthreads();
    // min_data_per_group: the count resets where a candidate is emitted
    if (tid < 2) {
      const int d = tid;
      float gcnt = 0.0f;
      for (int i = 0; i < used; ++i) {
        const float lh = cs.pref[d][1][i] + eps, lc = cs.pref[d][2][i];
        const float rh = sh - lh, rc = nd - lc;
        const bool ok = lc >= p.min_data && lh >= p.min_hess && rc >= p.min_data &&
                        rc >= cat.min_group && rh >= p.min_hess;
        gcnt = gcnt + pre[2 * kRow + cs.sorted[d == 0 ? i : used - 1 - i]];
        const bool e = ok && gcnt >= cat.min_group;
        if (e) gcnt = 0.0f;
        cs.emit[d][i] = e;
      }
    }
    __syncthreads();
    Params pc = p;
    pc.l2 = cat.l2;
    const int max_num_cat = min(cat.max_threshold, (used + 1) / 2);
    for (int i = tid; i < used; i += kThreads) {
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float lg = cs.pref[d][0][i], lh = cs.pref[d][1][i] + eps;
        const float rg = sg - lg, rh = sh - lh;
        const float lo = leaf_output_constrained(lg, lh, pc, min_c, max_c);
        const float ro = leaf_output_constrained(rg, rh, pc, min_c, max_c);
        const float g = gain_given_output(lg, lh, lo, pc) + gain_given_output(rg, rh, ro, pc);
        const bool ok = cs.emit[d][i] && i < max_num_cat && g > mgs;
        const int j = d * kMaxBins + i;  // candidate order: forward, then reverse
        if (beats<false>(ok ? g : -INFINITY, j, bg, bt)) { bg = ok ? g : -INFINITY; bt = j; }
      }
    }
    if (tid == 0) r.used = used;
  }
  warp_argmax<false>(bg, bt);
  if (lane == 0) { red_g[warp] = bg; red_t[warp] = bt; }
  __syncthreads();
  if (tid == 0) {
    float g = -INFINITY;
    int t = kBig;
    for (int w = 0; w < kWarps; ++w) {
      if (beats<false>(red_g[w], red_t[w], g, t)) { g = red_g[w]; t = red_t[w]; }
    }
    if (t == kBig) t = 0;  // no candidate: the first, as an argmax of -inf
    if (num_bin <= cat.max_onehot) {
      r.f = make_float4(g, pre[t], pre[kRow + t] + eps, pre[2 * kRow + t]);
      r.t = t;
      r.code = 1 << 1;
      r.mode = 0;
    } else {
      const int d = t >= kMaxBins, i = t - d * kMaxBins;
      r.f = make_float4(g, cs.pref[d][0][i], cs.pref[d][1][i] + eps, cs.pref[d][2][i]);
      r.t = i;
      r.code = ((i + 1) << 1) | (1 << 16);
      r.mode = 1 + d;
    }
  }
}

// A kCat block's publication: its words (written by threads < W) fenced,
// then thread 0 writes its record, fences and takes the child's ticket.
__device__ __forceinline__ void publish_cat(const CatRec& r, float* feat_f, int* feat_i,
                                            int* count, int c, int f, int F, int W, bool& last) {
  const int tid = threadIdx.x;
  if (tid < W) __threadfence();
  __syncthreads();
  if (tid == 0) {
    reinterpret_cast<float4*>(feat_f)[(long long)c * F + f] = r.f;
    reinterpret_cast<int2*>(feat_i)[(long long)c * F + f] = make_int2(r.t, r.code);
    __threadfence();  // the record and the words are visible before the ticket
    last = atomicAdd(&count[c], 1) == F - 1;
    if (last) __threadfence();  // and every other block's before the reads
  }
}

// The last block of child c: the feature argmax over the F records and the
// child's split record. A thread keeps the whole record of its best
// feature, so the winner's record needs no second read. Plain loads
// suffice: the fence before the ticket dropped this SM's L1 lines, so they
// read the records from L2.
template <bool kDev, bool kCat>
__device__ __forceinline__ void finish_child(const float* feat_f, const int* feat_i,
                                             float* __restrict__ outf, int* __restrict__ outi,
                                             int* count, int c, int F, int leaf,
                                             const LoopState ls, const Params p, const Cat cat,
                                             float sg, float sh_eff, float nd, float min_c,
                                             float max_c, float mgs, float (*red_g)[kWarps],
                                             int (*red_t)[kWarps]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float eps = (float)kEpsilon;
  float best = -INFINITY;
  int best_f = kBig;
  float4 rec = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int2 rec_i = make_int2(0, 0);
  for (int k = tid; k < F; k += kThreads) {
    const float4 r = reinterpret_cast<const float4*>(feat_f)[(long long)c * F + k];
    const int2 ri = reinterpret_cast<const int2*>(feat_i)[(long long)c * F + k];
    if (beats<false>(r.x, k, best, best_f)) { best = r.x; best_f = k; rec = r; rec_i = ri; }
  }
  float g = best;
  int fi = best_f;
  warp_argmax<false>(g, fi);
  if (lane == 0) { red_g[0][warp] = g; red_t[0][warp] = fi; }
  __syncthreads();
  if (warp == 0) {
    g = lane < kWarps ? red_g[0][lane] : -INFINITY;
    fi = lane < kWarps ? red_t[0][lane] : kBig;
    warp_argmax<false, kWarps>(g, fi);
    if (lane == 0) { red_g[1][0] = g; red_t[1][0] = fi; }
  }
  __syncthreads();
  const float g_best = red_g[1][0];
  const bool has_split = g_best > -INFINITY;
  const int fb = has_split ? red_t[1][0] : 0;
  if (best_f != fb) return;  // the one thread that holds the winner's record
  const float lg = rec.y, lh = rec.z, lc = rec.w;
  const float rg = sg - lg;
  const float rh = sh_eff - lh;
  const float rc = nd - lc;
  const int row = kDev ? leaf : c;
  const bool gated = kDev && ls.max_depth > 0 && ls.leaf_i[leaf * 2 + 1] >= ls.max_depth;
  Params po = p;
  if (kCat && (rec_i.y >> 16)) po.l2 = cat.l2;  // the CTR branch: lambda_l2 + cat_l2
  float* o = outf + row * 9;
  o[0] = has_split && !gated ? g_best - mgs : -INFINITY;
  o[1] = lg; o[2] = lh - eps; o[3] = lc;
  o[4] = rg; o[5] = rh - eps; o[6] = rc;
  o[7] = leaf_output_constrained(lg, lh, po, min_c, max_c);
  o[8] = leaf_output_constrained(rg, rh, po, min_c, max_c);
  int* oi = outi + row * 4;
  oi[0] = has_split ? fb : -1;
  oi[1] = rec_i.x;
  oi[2] = kCat ? (rec_i.y >> 1) & 0x7FFF : 0;
  oi[3] = kCat ? rec_i.y & 1 : rec_i.y;
  if constexpr (kCat) {
    const int* w = cat.feat_b + ((long long)c * F + fb) * cat.W;
    for (int k = 0; k < cat.W; ++k) cat.outb[(long long)row * cat.W + k] = __ldcg(w + k);
  }
  count[c] = 0;  // ready for the next call on this stream
}

template <bool kDev, bool kFold, bool kCat, bool kWide, bool kPool, bool kPen>
__global__ void __launch_bounds__(kThreads)
split_pair_kernel(float* hist, int leaf0, int leaf1,
                  const float* __restrict__ sums, const float* __restrict__ cons,
                  const int* __restrict__ num_bin_a, const int* __restrict__ missing_a,
                  const int* __restrict__ default_bin_a, const int* __restrict__ mono_a,
                  const unsigned char* __restrict__ fmask, float* feat_f, int* feat_i,
                  float* __restrict__ outf, int* __restrict__ outi, int* count, int F, int B,
                  Params p, int two_way, LoopState ls, Cat cat, Pen pen) {
  static_assert(!kPool || (kDev && kFold != kPen),
                "a pool's rows are read by the folded and the pooled all-leaves entries");
  static_assert(!kPen || kDev, "the penalised entries are the loop's");
  constexpr int kStage = Dims<kWide>::kStage, kRow = Dims<kWide>::kRow;
  __shared__ __align__(16) float pre[3 * kRow];  // [3, B] inclusive prefix, channel-major
  __shared__ float red_g[2][kWarps];
  __shared__ int red_t[2][kWarps];
  __shared__ bool last;
  if (kDev && !ls.ctl[kActive]) return;
  const int f = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int leaf = kDev ? ls.ctl[c == 0 ? kBest : kNew] : (c == 0 ? leaf0 : leaf1);
  if constexpr (kPen) {
    if (pen.all) {  // block (f, l): leaf l, unless the step paid no coupled feature
      if constexpr (kPool) {  // block (f, p): slot p's leaf; block (0, 0) patches
        const bool newly = pen.coupled != nullptr && ls.ctl[kNewly] != 0;
        if (newly && f == 0 && c == 0) patch_evicted(pen, ls.ctl, outf, outi);
        leaf = pen.slot_leaf[c];
        const bool child = leaf == ls.ctl[kBest] || leaf == ls.ctl[kNew];
        if (leaf < 0 || pen.slot_age[c] <= 0 || leaf >= ls.ctl[kNumLeaves] || !(child || newly))
          return;
      } else {
        leaf = c;
        if (!ls.ctl[kNewly] || leaf >= ls.ctl[kNumLeaves] || leaf == ls.ctl[kBest] ||
            leaf == ls.ctl[kNew])
          return;
      }
    }
  }
  // the child's sums and window: [3] and [2] floats
  const float* sc = kDev ? ls.laux + leaf * 5 : sums + c * 3;
  const float* cc = kDev ? ls.laux + leaf * 5 + 3 : cons + c * 2;
  const long long frow = (long long)f * B * 3;  // feature f's row in a [F, B, 3] histogram

  // every read of device memory the block needs, issued together: none
  // waits on another
  float v[kStage];
  if (!kFold) {  // the pooled all-leaves entry reads its slot's row
    const float* h = hist + (long long)(kPool ? c : leaf) * F * B * 3 + frow;
#pragma unroll
    for (int k = 0; k < kStage; ++k) {
      const int i = tid + k * kThreads;
      v[k] = i < B * 3 ? h[i] : 0.0f;
    }
  } else {
    const int small_leaf = ls.ctl[kSmall];
    const float* sp = ls.small + frow;
    if (kPool && leaf != small_leaf) {
      // the larger child's block of a pool: its rows are slots; on a hit
      // the subtraction from the parent's slot, which it takes over, on a
      // miss the larger child's own histogram
      const bool hit = ls.pool[kHit] != 0;
      const float* hp = hit ? hist + (long long)ls.pool[kPSlot] * F * B * 3 + frow
                            : ls.large + frow;
      float* hl = hist + (long long)ls.pool[kLSlot] * F * B * 3 + frow;
      float* hs = hist + (long long)ls.pool[kSSlot] * F * B * 3 + frow;
      float* zp = ls.large_zero + frow;
      float sv[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = tid + k * kThreads;
        v[k] = i < B * 3 ? hp[i] : 0.0f;
        sv[k] = i < B * 3 ? sp[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = tid + k * kThreads;
        if (hit) v[k] = v[k] - sv[k];
        if (i < B * 3) {
          hl[i] = v[k];
          hs[i] = sv[k];
          zp[i] = 0.0f;
        }
      }
    } else if (leaf != small_leaf) {
      // the larger child's block: the one reader of the parent's row and
      // the one writer of both children's rows of feature f
      const float* hp = hist + (long long)ls.ctl[kBest] * F * B * 3 + frow;
      float* hl = hist + (long long)leaf * F * B * 3 + frow;
      float* hs = hist + (long long)small_leaf * F * B * 3 + frow;
      float sv[kStage];
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = tid + k * kThreads;
        v[k] = i < B * 3 ? hp[i] : 0.0f;
        sv[k] = i < B * 3 ? sp[i] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = tid + k * kThreads;
        v[k] = v[k] - sv[k];
        if (i < B * 3) {
          hl[i] = v[k];
          hs[i] = sv[k];
        }
      }
    } else {
      // the smaller child's block: its row is the scratch's; it clears the
      // other scratch's row for the next step
      float* zp = ls.zero + frow;
#pragma unroll
      for (int k = 0; k < kStage; ++k) {
        const int i = tid + k * kThreads;
        v[k] = i < B * 3 ? sp[i] : 0.0f;
        if (i < B * 3) zp[i] = 0.0f;
      }
    }
  }
  const int num_bin = num_bin_a[f], miss = missing_a[f], dbin = default_bin_a[f];
  const int mono = mono_a[f];
  const bool use_feature = fmask[f];
  const float sg = sc[0], sh = sc[1], nd = sc[2];
  const float min_c = cc[0], max_c = cc[1];
  const bool multi_bin = num_bin > 2;
  const bool use_na = miss == 2 && multi_bin;
  const bool skip_def = miss == 1 && multi_bin;
  const bool single_scan = !(use_na || skip_def);
  const bool cat_f = kCat && cat.is_cat[f];  // a categorical block reads its row raw

  // stage the row, the excluded bins zeroed
#pragma unroll
  for (int k = 0; k < kStage; ++k) {
    const int i = tid + k * kThreads;
    const int b = i / 3;
    const bool excl = !cat_f &&
        (b >= num_bin || (skip_def && b == dbin) || (use_na && b == num_bin - 1));
    if (i < B * 3) pre[(i - 3 * b) * kRow + b] = excl ? 0.0f : v[k];
  }
  __syncthreads();
  // kPen: thread 0 reads the feature's penalty once the row is staged (the
  // row's registers free) and keeps it in shared memory until the record
  // is published
  [[maybe_unused]] float* pen_s = nullptr;
  if constexpr (kPen) {
    __shared__ float pen_v;
    pen_s = &pen_v;
    if (tid == 0) pen_v = cegb_penalty(pen, leaf, f, F, nd);
  }

  // the effective hessian and the gain shift, which the last block reads
  // too: in the numerical instantiations after the fold, where PR 16's
  // code computed them (its registers and SASS unchanged)
  float sh_eff, mgs;
  [[maybe_unused]] CatRec* rec_s = nullptr;
  if constexpr (kCat) {
    __shared__ CatSmem<kWide> cs;
    __shared__ CatRec rs;
    rec_s = &rs;
    sh_eff = sh + (float)(2.0 * kEpsilon);
    mgs = min_gain_shift(sg, sh, p);
    if (cat_f) {
      categorical_scan(pre, cs, rs, red_g[0], red_t[0], B, num_bin, miss, sg, sh, nd, min_c,
                       max_c, mgs, p, cat);
      if (tid == 0 && !use_feature) rs.f.x = -INFINITY;
      if constexpr (kPen) {
        if (tid == 0) rs.f.x = rs.f.x - *pen_s;
      }
      __syncthreads();
      // the block's words: the winner's bins
      if (tid < cat.W) {
        unsigned word = 0u;
        if (rs.mode == 0) {
          word = (rs.t >> 5) == tid ? 1u << (rs.t & 31) : 0u;
        } else {
          for (int k = 0; k < 32; ++k) {
            const int b = 32 * tid + k;
            if (b < num_bin && cs.valid[b] &&
                (rs.mode == 1 ? cs.rank[b] <= rs.t : cs.rank[b] >= rs.used - 1 - rs.t)) {
              word |= 1u << k;
            }
          }
        }
        cat.feat_b[((long long)c * F + f) * cat.W + tid] = (int)word;
      }
      publish_cat(rs, feat_f, feat_i, count, c, f, F, cat.W, last);
    }
  }
  if (!cat_f) {  // the numerical path
    if (tid < 3) fold_channel(pre + tid * kRow, B);
    __syncthreads();

    const float eps = (float)kEpsilon;
    if constexpr (!kCat) {
      sh_eff = sh + (float)(2.0 * kEpsilon);
      mgs = min_gain_shift(sg, sh, p);
    }
    const float tg = pre[B - 1], th = pre[kRow + B - 1], tc = pre[2 * kRow + B - 1];

    float best_gn = -INFINITY, best_gp = -INFINITY;
    int best_tn = -1, best_tp = kBig;
    for (int t = tid; t < B; t += kThreads) {
      const float pg = pre[t], ph = pre[kRow + t], pc = pre[2 * kRow + t];
      // dir = -1: right side accumulates from the top, default_left = true
      const float rg_n = tg - pg;
      const float rh_n = (th - ph) + eps;
      const float rc_n = tc - pc;
      const float lg_n = sg - rg_n, lh_n = sh_eff - rh_n, lc_n = nd - rc_n;
      const bool v_neg = t <= num_bin - 2 - (use_na ? 1 : 0) && !(skip_def && t == dbin - 1);
      const float gn = candidate_gain(lg_n, lh_n, rg_n, rh_n, lc_n, rc_n, v_neg, mono, min_c,
                                      max_c, mgs, p);
      if (beats<true>(gn, t, best_gn, best_tn)) { best_gn = gn; best_tn = t; }
      if (two_way) {
        // dir = +1: left side accumulates from the bottom, default_left = false
        const float lg_p = pg, lh_p = ph + eps, lc_p = pc;
        const float rg_p = sg - lg_p, rh_p = sh_eff - lh_p, rc_p = nd - lc_p;
        const bool v_pos = t <= num_bin - 2 && !(skip_def && t == dbin) && !single_scan;
        const float gp = candidate_gain(lg_p, lh_p, rg_p, rh_p, lc_p, rc_p, v_pos, mono, min_c,
                                        max_c, mgs, p);
        if (beats<false>(gp, t, best_gp, best_tp)) { best_gp = gp; best_tp = t; }
      }
    }
    warp_argmax<true>(best_gn, best_tn);
    warp_argmax<false>(best_gp, best_tp);
    if (lane == 0) {
      red_g[0][warp] = best_gn; red_t[0][warp] = best_tn;
      red_g[1][warp] = best_gp; red_t[1][warp] = best_tp;
    }
    __syncthreads();
    if (warp == 0) {
      float gn = lane < kWarps ? red_g[0][lane] : -INFINITY;
      int tn = lane < kWarps ? red_t[0][lane] : -1;
      float gp = lane < kWarps ? red_g[1][lane] : -INFINITY;
      int tp = lane < kWarps ? red_t[1][lane] : kBig;
      warp_argmax<true, kWarps>(gn, tn);
      warp_argmax<false, kWarps>(gp, tp);
      if (lane == 0) {
        const bool use_pos = gp > gn;  // +1 must beat -1 strictly
        float g = use_pos ? gp : gn;
        const int t = use_pos ? tp : tn;
        bool dl = !use_pos;
        if (miss == 2 && !multi_bin) dl = false;  // 2-bin NaN features
        if (!use_feature) g = -INFINITY;
        if constexpr (kPen) g = g - *pen_s;
        const float pg = pre[t], ph = pre[kRow + t], pc = pre[2 * kRow + t];
        float lg, lh, lc;
        if (use_pos) {
          lg = pg; lh = ph + eps; lc = pc;
        } else {
          const float rg_n = tg - pg, rh_n = (th - ph) + eps, rc_n = tc - pc;
          lg = sg - rg_n; lh = sh_eff - rh_n; lc = nd - rc_n;
        }
        if constexpr (kCat) {
          *rec_s = CatRec{make_float4(g, lg, lh, lc), t, dl ? 1 : 0, 0, 0};
        } else {
          reinterpret_cast<float4*>(feat_f)[(long long)c * F + f] = make_float4(g, lg, lh, lc);
          reinterpret_cast<int2*>(feat_i)[(long long)c * F + f] = make_int2(t, dl ? 1 : 0);
          __threadfence();  // the record is visible before the ticket
          last = atomicAdd(&count[c], 1) == F - 1;
          if (last) __threadfence();  // and every other block's record before the reads
        }
      }
    }
    if constexpr (kCat) {  // a numerical feature's words: the one-hot of its threshold
      __syncthreads();
      if (tid < cat.W) {
        const int t = rec_s->t;
        cat.feat_b[((long long)c * F + f) * cat.W + tid] = (t >> 5) == tid ? 1 << (t & 31) : 0;
      }
      publish_cat(*rec_s, feat_f, feat_i, count, c, f, F, cat.W, last);
    }
  }  // the numerical path
  __syncthreads();
  if (!last) return;
  finish_child<kDev, kCat>(feat_f, feat_i, outf, outi, count, c, F, leaf, ls, p, cat, sg, sh_eff,
                           nd, min_c, max_c, mgs, red_g, red_t);
}

// The categorical arguments both entries take after the others: is_cat
// [F] bytes (null: no categorical feature, the numerical instantiations),
// feat_b [C, F, W] int32 scratch, outb [rows, W] int32 (each record's
// membership words, W = ceil(B / 32)), max_cat_to_onehot, cat_smooth,
// lambda_l2 + cat_l2, max_cat_threshold and min_data_per_group.
bool cat_args_ok(const void* is_cat, const void* feat_b, const void* outb, int W, int B) {
  return is_cat == nullptr || (feat_b != nullptr && outb != nullptr && W == (B + 31) / 32);
}

// The instantiation of a launch: kDev, kFold, kPool and kPen as the entry
// asks, kCat with categorical features, kWide past the byte-width rows' 336
// bins.
using Kernel = decltype(&split_pair_kernel<false, false, false, false, false, false>);
template <bool kDev, bool kFold, bool kPool, bool kPen = false>
Kernel instantiation(bool cat, int B) {
  const bool wide = B > Dims<false>::kMaxBins;
  return cat ? (wide ? &split_pair_kernel<kDev, kFold, true, true, kPool, kPen>
                     : &split_pair_kernel<kDev, kFold, true, false, kPool, kPen>)
             : (wide ? &split_pair_kernel<kDev, kFold, false, true, kPool, kPen>
                     : &split_pair_kernel<kDev, kFold, false, false, kPool, kPen>);
}

// One step's forced record (see the header): gather_info_for_threshold of
// forced[k] = (leaf, feature, threshold) into frec_f [9] / frec_i [4] /
// frec_b [W] and ctl[kFLeaf], or ctl[kAbort] = 1 for an invalid split.
__global__ void __launch_bounds__(kThreads)
forced_record_kernel(const float* __restrict__ hist, int* ctl, const float* __restrict__ laux,
                     const int* __restrict__ leaf_i, const int* __restrict__ slot_of,
                     const int* __restrict__ forced, int k, const int* __restrict__ num_bin_a,
                     const int* __restrict__ missing_a, const int* __restrict__ default_bin_a,
                     const unsigned char* __restrict__ is_cat, int F, int B, int W,
                     int max_depth, Params p, float* __restrict__ frec_f,
                     int* __restrict__ frec_i, int* __restrict__ frec_b) {
  __shared__ float row[3][Dims<true>::kMaxBins];
  __shared__ float right[3];
  if (!ctl[kActive] || ctl[kAbort]) return;
  const int tid = threadIdx.x;
  const int leaf = forced[k * 3], f = forced[k * 3 + 1], thr = forced[k * 3 + 2];
  const int hrow = slot_of != nullptr ? max(slot_of[leaf], 0) : leaf;
  const float* h = hist + ((long long)hrow * F + f) * B * 3;
  for (int i = tid; i < B * 3; i += kThreads) row[i % 3][i / 3] = h[i];
  const int num_bin = num_bin_a[f], miss = missing_a[f], dbin = default_bin_a[f];
  const bool cat = is_cat != nullptr && is_cat[f];
  __syncthreads();
  if (tid < 3) {  // the right side's sums, a left fold in bin order
    const int hi = min(num_bin - 1 - (miss == 2 ? 1 : 0), B - 1);
    float acc = 0.0f;
    for (int b = max(thr, 1); b <= hi; ++b) {
      if (!(miss == 1 && b == dbin)) acc = acc + row[tid][b];
    }
    right[tid] = acc;
  }
  __syncthreads();
  if (tid != 0) return;
  const float eps = (float)kEpsilon;
  const float sg = laux[leaf * 5], sh = laux[leaf * 5 + 1], nd = laux[leaf * 5 + 2];
  const float mgs = gain_given_output(sg, sh, leaf_output(sg, sh, p), p) + p.min_gain;
  float lg, lh, lc;
  bool ok_cat = true;
  if (!cat) {
    lg = sg - right[0];
    lh = sh - (right[1] + eps);
    lc = nd - right[2];
  } else {
    const bool in = thr >= 0 && thr < B;
    lg = in ? row[0][thr] : 0.0f;
    lh = (in ? row[1][thr] : 0.0f) + eps;
    lc = in ? row[2][thr] : 0.0f;
    ok_cat = thr < num_bin - (miss != 0 ? 1 : 0);
  }
  const float rg = sg - lg, rh = sh - lh, rc = nd - lc;
  const float lo = leaf_output(lg, lh, p), ro = leaf_output(rg, rh, p);
  const float cur = gain_given_output(lg, lh, lo, p) + gain_given_output(rg, rh, ro, p);
  const bool ok = cur > mgs && ok_cat && !isnan(cur);
  const bool valid = ok && (max_depth <= 0 || leaf_i[leaf * 2 + 1] < max_depth);
  if (!valid) {
    ctl[kAbort] = 1;
    return;
  }
  const float r[9] = {cur - mgs, lg, lh - eps, lc, rg, rh - eps, rc, lo, ro};
  for (int c = 0; c < 9; ++c) frec_f[c] = r[c];
  frec_i[0] = f; frec_i[1] = thr; frec_i[2] = cat ? 1 : 0; frec_i[3] = cat ? 0 : 1;
  for (int w = 0; w < W; ++w) frec_b[w] = (thr >> 5) == w ? (int)(1u << (thr & 31)) : 0;
  ctl[kFLeaf] = leaf;
}

}  // namespace

extern "C" {

// Best split of each of C (1 or 2) children. hist [M, F, B, 3] f32, child c
// the leaf leaf0 or leaf1 of it; sums [C, 3] (sum_grad, sum_hess, count),
// cons [C, 2] (monotone min, max), per-feature int32 num_bin/missing_type/
// default_bin/monotone [F], fmask [F] bytes. Scratch feat_f [C, F, 4] f32
// and feat_i [C, F, 2] int32; count int32 [2], 0 between calls; out outf
// [C, 9], outi [C, 4]. B <= 1024 (the wide instantiations past 336).
int lgbt_split_pair(const void* hist, int leaf0, int leaf1, const void* sums, const void* cons,
                    const void* num_bin, const void* missing, const void* default_bin,
                    const void* mono, const void* fmask, void* feat_f, void* feat_i, void* outf,
                    void* outi, void* count, int C, int F, int B, float l1, float l2,
                    float max_delta_step, float min_data, float min_hess, float min_gain,
                    int two_way, const void* is_cat, void* feat_b, void* outb, int W,
                    int max_onehot, float cat_smooth, float cat_l2, int max_threshold,
                    float min_group, void* stream) {
  if (C <= 0 || C > 2 || F <= 0 || B <= 0 || B > Dims<true>::kMaxBins)
    return (int)cudaErrorInvalidValue;
  if (!cat_args_ok(is_cat, feat_b, outb, W, B)) return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, min_data, min_hess, min_gain};
  const Cat cat{(const unsigned char*)is_cat, (int*)feat_b, (int*)outb, W, max_onehot,
                max_threshold, cat_smooth, cat_l2, min_group};
  const LoopState ls{nullptr, nullptr, nullptr, 0, nullptr, nullptr, nullptr, nullptr, nullptr};
  const Kernel kern = instantiation<false, false, false>(is_cat != nullptr, B);
  kern<<<dim3(F, C), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)hist, leaf0, leaf1, (const float*)sums, (const float*)cons,
      (const int*)num_bin, (const int*)missing, (const int*)default_bin, (const int*)mono,
      (const unsigned char*)fmask, (float*)feat_f, (int*)feat_i, (float*)outf, (int*)outi,
      (int*)count, F, B, p, two_way, ls, cat, Pen{});
  return (int)cudaGetLastError();
}

// The device-indexed entry of the split loop: C = 1 scans leaf ctl[3] (the
// root), C = 2 the children ctl[3] and ctl[4] of the step's split, all read
// from device memory with their sums and windows from laux [M, 5] f32 and
// their depth from leaf_i [M, 2] int32; each record goes to the leaf's row
// of best_f [M, 9] / best_i [M, 4] (and best_b [M, W] as outb), its gain
// -inf at a depth >= max_depth (> 0). With small non-null (C = 2 only: a
// step's scan), the children's rows are folded in first: hist[ctl[6]] =
// hist[ctl[3]] - small, hist[ctl[5]] = small, and zero [F, B, 3] is
// cleared; small and zero are the two scratch buffers, never the same.
// With pool non-null as well (a histogram pool: hist holds slots), the rows
// are the slots of the pool's control vector pool [16] int32 (hit, and the
// smaller child's, the larger's and the parent's slot at 10-13): hist[lslot]
// = hit ? hist[pslot] - small : large, hist[sslot] = small, and large_zero
// [F, B, 3] is cleared too. Nothing runs once ctl[0] is 0. The other
// arguments are lgbt_split_pair's.
int lgbt_split_pair_dev(void* hist, const void* ctl, const void* laux, const void* leaf_i,
                        const void* small, void* zero, const void* pool, const void* large,
                        void* large_zero, int max_depth, const void* num_bin,
                        const void* missing, const void* default_bin, const void* mono,
                        const void* fmask, void* feat_f, void* feat_i, void* best_f,
                        void* best_i, void* count, int C, int F, int B, float l1, float l2,
                        float max_delta_step, float min_data, float min_hess, float min_gain,
                        int two_way, const void* is_cat, void* feat_b, void* outb, int W,
                        int max_onehot, float cat_smooth, float cat_l2, int max_threshold,
                        float min_group, void* stream) {
  if (C <= 0 || C > 2 || F <= 0 || B <= 0 || B > Dims<true>::kMaxBins)
    return (int)cudaErrorInvalidValue;
  if (!cat_args_ok(is_cat, feat_b, outb, W, B)) return (int)cudaErrorInvalidValue;
  const bool fold = small != nullptr;
  if (fold && (C != 2 || zero == nullptr || zero == small)) return (int)cudaErrorInvalidValue;
  const bool pooled = pool != nullptr;
  if (pooled && (!fold || large == nullptr || large_zero == nullptr || large == large_zero))
    return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, min_data, min_hess, min_gain};
  const LoopState ls{(const int*)ctl, (const float*)laux, (const int*)leaf_i, max_depth,
                     (const float*)small, (float*)zero, (const int*)pool, (const float*)large,
                     (float*)large_zero};
  const Cat cat{(const unsigned char*)is_cat, (int*)feat_b, (int*)outb, W, max_onehot,
                max_threshold, cat_smooth, cat_l2, min_group};
  const bool c = is_cat != nullptr;
  const Kernel kern = pooled ? instantiation<true, true, true>(c, B)
                             : (fold ? instantiation<true, true, false>(c, B)
                                     : instantiation<true, false, false>(c, B));
  kern<<<dim3(F, C), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)hist, 0, 0, nullptr, nullptr, (const int*)num_bin, (const int*)missing,
      (const int*)default_bin, (const int*)mono, (const unsigned char*)fmask, (float*)feat_f,
      (int*)feat_i, (float*)best_f, (int*)best_i, (int*)count, F, B, p, two_way, ls, cat, Pen{});
  return (int)cudaGetLastError();
}

// The penalised (CEGB) entries of the split loop: lgbt_split_pair_dev's
// root (C = 1) and folded (small non-null, C = 2) entries, with each
// feature's penalty subtracted before the argmax over features; or, with
// all = 1, the all-leaves entry (C = M: block (f, l) scans leaf l
// when ctl[12] is set, l < ctl[1] and l is neither child ctl[3] nor
// ctl[4]; its tickets count [M], its scratch feat_f [M, F, 4], feat_i [M,
// F, 2] and feat_b [M, F, W]). feature_used [F] bytes and coupled [F] f32
// (tradeoff * coupled) with coupled penalties, else null; unused [M, F]
// and lazy [F] f32 (tradeoff * lazy) with lazy ones, else null; split =
// tradeoff * penalty_split. A histogram pool (pool non-null: its buffer
// [16 + M + 2 P] int32, the control vector, slot_of, slot_leaf, slot_age;
// all = 1 only): the pooled all-leaves entry (C = P: block (f, p) scans
// slot p's leaf from its row, the children every step, with or without
// coupled penalties, and with them the evicted leaves' records are
// patched, reading the step's feature from node_i [M, 5]); a pooled
// step's folded scan is lgbt_split_pair_dev's. The other
// arguments are lgbt_split_pair_dev's.
int lgbt_split_pair_cegb(void* hist, const void* ctl, const void* laux, const void* leaf_i,
                         const void* small, void* zero, int max_depth, const void* num_bin,
                         const void* missing, const void* default_bin, const void* mono,
                         const void* fmask, void* feat_f, void* feat_i, void* best_f,
                         void* best_i, void* count, int C, int F, int B, float l1, float l2,
                         float max_delta_step, float min_data, float min_hess, float min_gain,
                         int two_way, const void* is_cat, void* feat_b, void* outb, int W,
                         int max_onehot, float cat_smooth, float cat_l2, int max_threshold,
                         float min_group, const void* feature_used, const void* unused,
                         const void* coupled, const void* lazy, float split, int all,
                         const void* pool, int M, int P, const void* node_i, void* stream) {
  if (C <= 0 || F <= 0 || B <= 0 || B > Dims<true>::kMaxBins) return (int)cudaErrorInvalidValue;
  if (!cat_args_ok(is_cat, feat_b, outb, W, B)) return (int)cudaErrorInvalidValue;
  const bool fold = small != nullptr;
  if (all ? fold : (C > 2 || (fold && (C != 2 || zero == nullptr || zero == small))))
    return (int)cudaErrorInvalidValue;
  if ((coupled == nullptr) != (feature_used == nullptr) || (lazy == nullptr) != (unused == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool pooled = pool != nullptr;
  if (pooled && (P < 2 || P > M || !all || C != P || node_i == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, min_data, min_hess, min_gain};
  const int* pv = (const int*)pool;
  const LoopState ls{(const int*)ctl, (const float*)laux, (const int*)leaf_i, max_depth,
                     (const float*)small, (float*)zero, pv, nullptr, nullptr};
  const Cat cat{(const unsigned char*)is_cat, (int*)feat_b, (int*)outb, W, max_onehot,
                max_threshold, cat_smooth, cat_l2, min_group};
  const Pen pen{(const unsigned char*)feature_used, (const float*)unused, (const float*)coupled,
                (const float*)lazy, split, all,
                pooled ? pv + 16 : nullptr, pooled ? pv + 16 + M : nullptr,
                pooled ? pv + 16 + M + P : nullptr, (const int*)node_i};
  const bool c = is_cat != nullptr;
  const Kernel kern = pooled ? instantiation<true, false, true, true>(c, B)
                             : (fold ? instantiation<true, true, false, true>(c, B)
                                     : instantiation<true, false, false, true>(c, B));
  kern<<<dim3(F, C), kThreads, 0, (cudaStream_t)stream>>>(
      (float*)hist, 0, 0, nullptr, nullptr, (const int*)num_bin, (const int*)missing,
      (const int*)default_bin, (const int*)mono, (const unsigned char*)fmask, (float*)feat_f,
      (int*)feat_i, (float*)best_f, (int*)best_i, (int*)count, F, B, p, two_way, ls, cat, pen);
  return (int)cudaGetLastError();
}

// One step's forced record: forced [K, 3] int32 (leaf, used feature,
// threshold bin) row k, the leaf's histogram row hist [rows, F, B, 3] (its
// slot slot_of[leaf] under a pool, slot_of null without one), its sums
// laux [M, 5] and depth leaf_i [M, 2]; is_cat [F] bytes or null. Writes
// frec_f [9] f32, frec_i [4] int32, frec_b [W] int32 and ctl[10] (the
// leaf), or ctl[11] = 1 when the split is invalid (gain -inf, or the leaf
// at max_depth > 0). Nothing once ctl[0] is 0 or ctl[11] is set.
int lgbt_forced_record(const void* hist, void* ctl, const void* laux, const void* leaf_i,
                       const void* slot_of, const void* forced, int k, const void* num_bin,
                       const void* missing, const void* default_bin, const void* is_cat, int F,
                       int B, int W, int max_depth, float l1, float l2, float max_delta_step,
                       float min_gain, void* frec_f, void* frec_i, void* frec_b, void* stream) {
  if (F <= 0 || B <= 0 || B > Dims<true>::kMaxBins || k < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{l1, l2, max_delta_step, 0.0f, 0.0f, min_gain};
  forced_record_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (int*)ctl, (const float*)laux, (const int*)leaf_i, (const int*)slot_of,
      (const int*)forced, k, (const int*)num_bin, (const int*)missing, (const int*)default_bin,
      (const unsigned char*)is_cat, F, B, W, max_depth, p, (float*)frec_f, (int*)frec_i,
      (int*)frec_b);
  return (int)cudaGetLastError();
}

}  // extern "C"
