// LambdaRank's pairwise lambdas and hessians, for Hopper (sm_90a): lambdarank.
//
// Counterpart of ``_lambdarank_bucket`` and ``LambdarankNDCG.get_gradients``
// in lightgbm_tpu/objective.py:842-887,948-960 (XLA code there, no Pallas
// kernel; the reference's per-query loop, rank_objective.hpp:82-160). The
// TPU program pads each query to a power-of-two bucket and builds dense
// [queries, S, S] pair tensors; here one block takes one query and no
// [S, S] tensor exists. The plain version is ops/rank.py ``lambdas``, the
// TPU program's bucketed formulation in torch with its sums in f64; the two
// agree within the tolerance the JAX package holds its own twin to (rtol
// 2e-4, atol 2e-6): the exp and the summation order differ.
//
// A query is the rows [qb[q], qb[q + 1]). Its block:
//  1. stages the query's scores, labels and label gains in shared memory
//     (a query of more than kSmemRows rows reads them from global memory
//     instead, and keeps its discounts in the global scratch);
//  2. gives each row its rank in a stable descending sort of the scores,
//     the number of rows with a larger score plus the rows before it with
//     an equal one, and its discount 1 / log2(2 + rank); finds the query's
//     best and worst score by a block reduction;
//  3. each thread sums, for each of its rows i, over every row j with
//     label_i > label_j the pair's lambda and hessian, and over every row
//     j with label_j > label_i those of the pair (j, i):
//       g_i = sum lam_ij - sum lam_ji,  h_i = sum hes_ij + sum hes_ji,
//     with delta = (gain_i - gain_j) * |disc_i - disc_j| * invq, divided by
//     0.01 + |s_i - s_j| unless every score of the query is equal, and
//     p = 2 / (1 + exp(2 (s_i - s_j) sigmoid)), lam = -p delta,
//     hes = p (2 - p) 2 delta; then multiplies both by the row's weight.
// A query of one row, or whose labels are all equal, gets zeros. There are
// no atomics: each row's sums run in one fixed order, so a launch on the
// same scores gives the same bits. The four sums accumulate the f32 terms in
// f64 (their difference g_i cancels: a query's lambdas run into the
// thousands of terms), and each result is rounded to f32 once.
//
// What bounds it: operations. The bytes are a score, a label, a gain and a
// weight read and a gradient and a hessian written a row (24 bytes: 48 MB
// at 2M rows, 14 us on 3.35 TB/s); the work the function needs is 23 f32
// operations for each unordered pair with unequal labels: 19 of the pair's
// formula (its exp and its two divisions each priced as one operation) and
// the four sums it enters. This kernel does more: it computes each such
// pair from both of its rows (twice, for no atomics) and counts the ranks
// over every ordered pair, at 16,700 queries of mean size 120 and a long
// tail to 1,251 rows about 10^9 pairs. One block a query keeps a query's rows
// in shared memory; the long queries, whose pairs are most of the work,
// take one block each, which bounds the launch by its largest query: the
// blocks take the queries largest first (``qorder``, from the plan), so the
// long ones start at once and the short ones fill the card behind them, and
// a block has 256 threads, so that a long query's warps hide each other's
// latency. A second pass that splits a long query over several blocks is
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemRows = 2560;  // 4 arrays x 4 bytes x 2560 rows = 40 KB of shared memory

struct Args {
  const float* score;   // [N] this class's scores
  const int* label;     // [N] integer labels
  const float* gain;    // [N] each row's label gain (f32)
  const float* weight;  // [N] row weights, or null
  const int* qb;        // [Q + 1] query boundaries
  const int* qorder;    // [Q] the query of each block: the largest first
  const float* invq;    // [Q] inverse max DCG of each query (f32)
  float* grad;          // [N]
  float* hess;          // [N]
  float* scratch;       // [N] discounts of the queries above kSmemRows rows, or null
  float sigmoid;
};

__global__ void __launch_bounds__(kThreads) lambdarank_kernel(Args a) {
  __shared__ float sh_s[kSmemRows];
  __shared__ int sh_l[kSmemRows];
  __shared__ float sh_g[kSmemRows];
  __shared__ float sh_d[kSmemRows];
  __shared__ float red_max[kThreads / 32], red_min[kThreads / 32];
  const int q = a.qorder[blockIdx.x], t = threadIdx.x;
  const int lo = a.qb[q], cnt = a.qb[q + 1] - lo;
  if (cnt <= 1) {
    if (t < cnt) {
      a.grad[lo] = 0.0f;
      a.hess[lo] = 0.0f;
    }
    return;
  }
  const bool fits = cnt <= kSmemRows;
  const float* s = fits ? sh_s : a.score + lo;
  const int* l = fits ? sh_l : a.label + lo;
  const float* g = fits ? sh_g : a.gain + lo;
  float* d = fits ? sh_d : a.scratch + lo;
  if (fits) {
    for (int i = t; i < cnt; i += kThreads) {
      sh_s[i] = a.score[lo + i];
      sh_l[i] = a.label[lo + i];
      sh_g[i] = a.gain[lo + i];
    }
    __syncthreads();
  }
  // ranks, discounts, best and worst
  float best = -INFINITY, worst = INFINITY;
  for (int i = t; i < cnt; i += kThreads) {
    const float si = s[i];
    int r = 0;
    for (int j = 0; j < cnt; ++j) {
      const float sj = s[j];
      r += (sj > si) || (sj == si && j < i);
    }
    d[i] = 1.0f / log2f(2.0f + (float)r);
    best = fmaxf(best, si);
    worst = fminf(worst, si);
  }
  for (int o = 16; o > 0; o >>= 1) {
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, o));
    worst = fminf(worst, __shfl_xor_sync(0xffffffffu, worst, o));
  }
  if ((t & 31) == 0) {
    red_max[t >> 5] = best;
    red_min[t >> 5] = worst;
  }
  __syncthreads();  // the discounts (shared or global) and the reductions are complete
  best = red_max[0];
  worst = red_min[0];
  for (int w = 1; w < kThreads / 32; ++w) {
    best = fmaxf(best, red_max[w]);
    worst = fminf(worst, red_min[w]);
  }
  const bool spread = best != worst;
  const float invq = a.invq[q], sig = a.sigmoid;
  for (int i = t; i < cnt; i += kThreads) {
    const float si = s[i], gi = g[i], di = d[i];
    const int li = l[i];
    double gp = 0.0, gn = 0.0, hp = 0.0, hn = 0.0;
    for (int j = 0; j < cnt; ++j) {
      const int lj = l[j];
      if (lj == li) continue;
      const float sj = s[j], gj = g[j], dj = d[j];
      // the pair (high, low): high is i when its label is larger
      const bool high = li > lj;
      const float ds = high ? si - sj : sj - si;
      float delta = ((high ? gi - gj : gj - gi) * fabsf(high ? di - dj : dj - di)) * invq;
      if (spread) delta = delta / (0.01f + fabsf(ds));
      const float p = 2.0f / (1.0f + expf((2.0f * ds) * sig));
      const float lam = -p * delta;
      const float hes = ((p * (2.0f - p)) * 2.0f) * delta;
      if (high) {
        gp += lam;
        hp += hes;
      } else {
        gn += lam;
        hn += hes;
      }
    }
    float gr = (float)(gp - gn), he = (float)(hp + hn);
    if (a.weight != nullptr) {
      const float w = a.weight[lo + i];
      gr *= w;
      he *= w;
    }
    a.grad[lo + i] = gr;
    a.hess[lo + i] = he;
  }
}

}  // namespace

extern "C" {

// grad, hess [N] f32 = LambdaRank's lambdas and hessians of the Q queries
// qb [Q + 1] int32 over score, gain [N] f32 and label [N] int32, with invq
// [Q] f32 and weight [N] f32 (or null), block b taking query qorder[b]
// (qorder [Q] int32, a permutation); scratch [N] f32 must be given when a
// query has more than kSmemRows rows (ops/rank_kernel.py SMEM_ROWS).
int lgbt_lambdarank(const void* score, const void* label, const void* gain, const void* weight,
                    const void* qb, const void* qorder, const void* invq, void* grad, void* hess,
                    void* scratch, float sigmoid, int Q, void* stream) {
  if (Q < 1) return (int)cudaErrorInvalidValue;
  Args a{(const float*)score, (const int*)label, (const float*)gain, (const float*)weight,
         (const int*)qb, (const int*)qorder, (const float*)invq, (float*)grad, (float*)hess,
         (float*)scratch, sigmoid};
  lambdarank_kernel<<<Q, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
