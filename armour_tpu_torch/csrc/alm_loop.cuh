// K14's phases as device code: the bookkeeping of the ALM solve loop
// between the row kernels K7 (alm_newton.cu) and K8 (alm_values.cu).
//
// Replaces the element-wise and selection work of armour_tpu/nlp.py:427-600
// (_alm_phases and _finalize) and the best-start choice of solve
// (:403-416), which XLA fuses into the jitted loop: the best-feasible
// tracker, the line search's ladder and accept test, the multiplier and
// penalty update, the cull, the pull-in bisection and the final selection.
// Plain versions: nlp.py:alm_init_plain ... alm_select_plain.
//
// Every phase but two runs as the epilogue of the row pass that feeds it
// (AlmArgs.epi, alm_rows.cuh): the ladder in K7's finish, a thread per
// (world, seed) after its step; init, accept, outer, the pull-in's start,
// steps and end and finish in K8's finish, a block per world after its
// queries are reduced, a thread per seed (outer's multiplier update: in
// K8's row passes, where each row's lam + rho c is formed for the merit).
// The cull (after a torch sum of the violations) and the selection (after
// the full-set check) keep launches of their own (alm_loop.cu).
//
// What bounded the phases as launches of their own (the first design, 39
// launches a W = 64 step): each one's launch, ~4.8 us of device time
// against ~0.26 us of bytes, and a ctypes call on the host.  As epilogues
// they read the row pass's outputs from registers or shared memory, not
// back from device memory, and cost no launch.
//
// Each phase repeats its plain version's float32 operations in their order
// (built with -fmad=false: k - alpha step is a multiply, then a subtract),
// and torch's rules where the plain version selects: torch.clamp keeps a
// NaN and is min(max(x, lo), hi) otherwise; torch.argmin takes a NaN first,
// then the lower index on ties; argsort(stable=True) puts NaN last and
// keeps the index order on ties; a comparison with a Python threshold
// compares in float32.  The epilogues read the same floats the row pass
// writes, so the phases give the plain versions' bits.  Every output is a
// new buffer; no input is written.
#pragma once
#include <cuda_runtime.h>

#define K14_THREADS 128
#define K14_MAX_A 16
#define K14_MAX_S 8
#define K14_MAX_F 8

// the epilogue phases, kernels/solver.py:EPI_PHASES in order
#define ALM_EPI_NONE 0
#define ALM_EPI_INIT 1
#define ALM_EPI_LADDER 2
#define ALM_EPI_ACCEPT 3
#define ALM_EPI_OUTER 4
#define ALM_EPI_PULL_START 5
#define ALM_EPI_PULL_STEP 6
#define ALM_EPI_PULL_END 7
#define ALM_EPI_FINISH 8

// A phase run by the row pass's finish (i = w S + s indexes [W, S] arrays).
// Its inputs beside the row pass's own, and its outputs, as
// kernels/solver.py:ALM_EPILOGUES lists them per phase.
struct AlmEpilogue {
  int phase;                        // ALM_EPI_*; ALM_EPI_NONE: the row pass alone
  int A;                            // ladder points per seed (ladder, accept)
  const float* k;                   // [W, S, F] the iterate (accept, pull_end, finish)
  const float* m0;                  // [W, S] K7's merit at k (accept)
  const float* best_k;              // [W, S, F] the tracker
  const float* best_cost;           // [W, S]
  const float* lo;                  // [W, S, F] the pull-in's bracket (pull_step, pull_end)
  const float* hi;                  // [W, S, F] (pull_step)
  const unsigned char* end_feas;    // [W, S] K8's feasibility of k (pull_end)
  float* k_out;                     // ladder [W, S A, F]; accept, pull_end [W, S, F];
                                    // finish [W, 2 S, F] (k, then best_k)
  float* best_k_out;                // [W, S, F]
  float* best_cost_out;             // [W, S]
  float* lam_out;                   // [W, S, M] (outer)
  float* rho_out;                   // [W, S] (outer)
  float* lo_out;                    // [W, S, F] (pull_start, pull_step)
  float* hi_out;
  float* mid_out;
  float alphas[K14_MAX_A];          // cfg.solver_alphas, as float32 (ladder)
};

// torch.clamp(x, lo, hi)
__device__ __forceinline__ float k14_clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.argmin's order: is (a, ia) before (b, ib)?
__device__ __forceinline__ bool k14_less_or_nan(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) ? ia < ib : true;
  return a == b ? ia < ib : a < b;
}

// argsort(stable=True)'s ascending order, NaN last: is (a, ia) before (b, ib)?
__device__ __forceinline__ bool k14_sort_less(float a, int ia, float b, int ib) {
  if (isnan(a)) return isnan(b) && ia < ib;
  if (isnan(b)) return true;
  return a == b ? ia < ib : a < b;
}

// track_best: fold the point kk [F] with (feas, cost) into (bk [F], bc)
__device__ __forceinline__ void k14_track(const float* kk, bool feas, float cost, float* bk,
                                          float& bc, int F) {
  if (feas && cost < bc) {
    for (int f = 0; f < F; ++f) bk[f] = kk[f];
    bc = cost;
  }
}

__device__ __forceinline__ void k14_copy(const float* src, float* dst, int F) {
  for (int f = 0; f < F; ++f) dst[f] = src[f];
}

// the tracker of (world, seed) i with the point kk folded in, written out
__device__ __forceinline__ void k14_track_out(const AlmEpilogue& e, long long i, const float* kk,
                                              bool feas, float cost, int F) {
  float bk[K14_MAX_F];
  k14_copy(e.best_k + i * F, bk, F);
  float bc = e.best_cost[i];
  k14_track(kk, feas, cost, bk, bc, F);
  k14_copy(bk, e.best_k_out + i * F, F);
  e.best_cost_out[i] = bc;
}

// init (after K8 at the starts kk): the tracker at the starts
__device__ __forceinline__ void alm_epi_init(const AlmEpilogue& e, long long i, const float* kk,
                                             bool feas, float cost, int F) {
  k14_copy(kk, e.best_k_out + i * F, F);
  e.best_cost_out[i] = feas ? cost : INFINITY;
}

// ladder (after K7 at kk, its step st): fold kk into the tracker, then the
// A clamped ladder points of the seed
__device__ __forceinline__ void alm_epi_ladder(const AlmEpilogue& e, long long i, const float* kk,
                                               const float* st, bool feas, float cost, int F) {
  k14_track_out(e, i, kk, feas, cost, F);
  for (int a = 0; a < e.A; ++a) {
    float* o = e.k_out + (i * e.A + a) * F;
    for (int f = 0; f < F; ++f) o[f] = k14_clamp(kk[f] - e.alphas[a] * st[f], -1.0f, 1.0f);
  }
}

// accept (after K8 on the ladder of seed s): its A candidates kq [S A, F]
// (the world's queries) with merit / feas / cost [S A] into the tracker in
// order, then the first of least merit replaces k when below m0
__device__ __forceinline__ void alm_epi_accept(const AlmEpilogue& e, long long i, int s,
                                               const float* kq, const float* merit,
                                               const unsigned char* feas, const float* cost,
                                               int F) {
  const int A = e.A, q0 = s * A;
  float bk[K14_MAX_F];
  k14_copy(e.best_k + i * F, bk, F);
  float bc = e.best_cost[i];
  for (int a = 0; a < A; ++a) k14_track(kq + (q0 + a) * F, feas[q0 + a] != 0, cost[q0 + a], bk,
                                        bc, F);
  k14_copy(bk, e.best_k_out + i * F, F);
  e.best_cost_out[i] = bc;
  int best = 0;
  for (int a = 1; a < A; ++a)
    if (k14_less_or_nan(merit[q0 + a], a, merit[q0 + best], best)) best = a;
  const float* src = merit[q0 + best] < e.m0[i] ? kq + (q0 + best) * F : e.k + i * F;
  k14_copy(src, e.k_out + i * F, F);
}

// outer (after K8 at the outer iterate kk), a seed's part: fold kk into the
// tracker and double rho (at most 1e6)
__device__ __forceinline__ void alm_epi_outer(const AlmEpilogue& e, long long i, const float* kk,
                                              bool feas, float cost, float rho, int F) {
  const float r = rho * 2.0f;
  e.rho_out[i] = isnan(r) ? r : fminf(r, 1e6f);
  k14_track_out(e, i, kk, feas, cost, F);
}

// outer, a multiplier's part: lam = max(lam + rho c, 0) of the clipped row
// c, where K8 forms it (kept a NaN, as torch.clamp)
__device__ __forceinline__ void alm_epi_lam(const AlmEpilogue& e, long long at, float lam,
                                            float rho, float c) {
  if (e.phase != ALM_EPI_OUTER) return;
  const float z = lam + rho * c;
  e.lam_out[at] = isnan(z) ? z : fmaxf(z, 0.0f);
}

// pull_start (after K8 at the end iterate kk): the bracket [lo, hi] =
// [best_k where the tracker holds a point else kk, kk] and its midpoint
__device__ __forceinline__ void alm_epi_pull_start(const AlmEpilogue& e, long long i,
                                                   const float* kk, int F) {
  const bool have = isfinite(e.best_cost[i]);
  for (int f = 0; f < F; ++f) {
    const float kf = kk[f];
    const float l = have ? e.best_k[i * F + f] : kf;
    e.lo_out[i * F + f] = l;
    e.hi_out[i * F + f] = kf;
    e.mid_out[i * F + f] = 0.5f * (l + kf);
  }
}

// pull_step (after K8 at the midpoint mid): one bisection step on its
// feasibility ok, and the next midpoint
__device__ __forceinline__ void alm_epi_pull_step(const AlmEpilogue& e, long long i,
                                                  const float* mid, bool ok, int F) {
  for (int f = 0; f < F; ++f) {
    const long long x = i * F + f;
    const float l = ok ? mid[f] : e.lo[x];
    const float h = ok ? e.hi[x] : mid[f];
    e.lo_out[x] = l;
    e.hi_out[x] = h;
    e.mid_out[x] = 0.5f * (l + h);
  }
}

// pull_end (after K8 at the last midpoint mid): the last bisection step,
// then k_pull = lo where k ended infeasible and the tracker holds a point,
// else k
__device__ __forceinline__ void alm_epi_pull_end(const AlmEpilogue& e, long long i,
                                                 const float* mid, bool ok, int F) {
  const bool pull = !e.end_feas[i] && isfinite(e.best_cost[i]);
  for (int f = 0; f < F; ++f) {
    const long long x = i * F + f;
    e.k_out[x] = pull ? (ok ? mid[f] : e.lo[x]) : e.k[x];
  }
}

// finish (after K8 at k_pull kp): fold kp into the tracker; kb = [k, best_k]
// of world w, seed s of S
__device__ __forceinline__ void alm_epi_finish(const AlmEpilogue& e, long long w, int s, int S,
                                               const float* kp, bool feas, float cost, int F) {
  const long long i = w * S + s;
  float bk[K14_MAX_F];
  k14_copy(e.best_k + i * F, bk, F);
  float bc = e.best_cost[i];
  k14_track(kp, feas, cost, bk, bc, F);
  k14_copy(e.k + i * F, e.k_out + (w * 2 * S + s) * F, F);
  k14_copy(bk, e.k_out + (w * 2 * S + S + s) * F, F);
  e.best_cost_out[i] = bc;
}
