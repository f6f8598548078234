// K14: the bookkeeping of the ALM solve loop between the row kernels K7 and
// K8, one launch per phase.
//
// Replaces the element-wise and selection work of armour_tpu/nlp.py:427-600
// (_alm_phases and _finalize) and the best-start choice of solve
// (:403-416), which XLA fuses into the jitted loop: the best-feasible
// tracker, the line search's ladder and accept test, the multiplier and
// penalty update, the cull, the pull-in bisection and the final selection.
// Plain versions: nlp.py:alm_init_plain, alm_ladder_plain, alm_accept_plain,
// alm_outer_plain, alm_cull_plain, alm_pull_start_plain, alm_pull_step_plain,
// alm_pull_end_plain, alm_finish_plain, alm_select_plain.  Every output is a
// new buffer; no input is written.
//
// Each phase repeats its plain version's float32 operations in their order
// (built with -fmad=false: k - alpha step is a multiply, then a subtract),
// and torch's rules where the plain version selects: torch.clamp keeps a
// NaN and is min(max(x, lo), hi) otherwise; torch.argmin takes a NaN first,
// then the lower index on ties; argsort(stable=True) puts NaN last and
// keeps the index order on ties; a comparison with a Python threshold
// compares in float32.  So the phases give the plain versions' bits.
//
// Geometry (kernels/solver.py:k14_geometry): a thread per (world, seed)
// for the tracker phases, a thread per multiplier for the outer update, a
// CTA per (kept seed, M tile) for the cull's gather (each thread ranks the
// S <= 8 scores itself: no shared memory, no barrier), a thread per world
// for the selection.  Bound on the H100: the bytes over 3.35 TB/s, a few
// microseconds at W = 64 (the outer update and the cull move the [W, S, M]
// multipliers, ~6 MB); each phase's time is its launch.
#include <cuda_runtime.h>

#define K14_THREADS 128
#define K14_MAX_A 16
#define K14_MAX_S 8
#define K14_MAX_F 8

struct K14Alphas {
  float a[K14_MAX_A];               // cfg.solver_alphas, as float32
};

__device__ __forceinline__ long long k14_index() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

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

__device__ __forceinline__ void k14_load(const float* src, float* dst, int F) {
  for (int f = 0; f < F; ++f) dst[f] = src[f];
}

__device__ __forceinline__ void k14_store(const float* src, float* dst, int F) {
  for (int f = 0; f < F; ++f) dst[f] = src[f];
}

// init: the tracker at the starts
__global__ void __launch_bounds__(K14_THREADS) k14_init_kernel(
    const float* k, const unsigned char* feas, const float* cost, float* best_k,
    float* best_cost, int n, int F) {
  const long long i = k14_index();
  if (i >= n) return;
  k14_store(k + i * F, best_k + i * F, F);
  best_cost[i] = feas[i] ? cost[i] : INFINITY;
}

// ladder: fold k into the tracker, then the A clamped ladder points per seed
__global__ void __launch_bounds__(K14_THREADS) k14_ladder_kernel(
    const float* k, const float* step, const unsigned char* feas, const float* cost,
    const float* best_k, const float* best_cost, float* kq, float* best_k_out,
    float* best_cost_out, int n, int F, int A, const K14Alphas al) {
  const long long i = k14_index();
  if (i >= n) return;
  float kk[K14_MAX_F], st[K14_MAX_F], bk[K14_MAX_F];
  k14_load(k + i * F, kk, F);
  k14_load(step + i * F, st, F);
  k14_load(best_k + i * F, bk, F);
  float bc = best_cost[i];
  k14_track(kk, feas[i] != 0, cost[i], bk, bc, F);
  k14_store(bk, best_k_out + i * F, F);
  best_cost_out[i] = bc;
  for (int a = 0; a < A; ++a) {
    float* o = kq + (i * A + a) * F;
    for (int f = 0; f < F; ++f) o[f] = k14_clamp(kk[f] - al.a[a] * st[f], -1.0f, 1.0f);
  }
}

// accept: the A candidates into the tracker in order, then the first of
// least merit replaces k when below m0
__global__ void __launch_bounds__(K14_THREADS) k14_accept_kernel(
    const float* k, const float* m0, const float* kq, const float* merit,
    const unsigned char* feas, const float* cost, const float* best_k, const float* best_cost,
    float* k_out, float* best_k_out, float* best_cost_out, int n, int F, int A) {
  const long long i = k14_index();
  if (i >= n) return;
  float bk[K14_MAX_F];
  k14_load(best_k + i * F, bk, F);
  float bc = best_cost[i];
  for (int a = 0; a < A; ++a) {
    const long long q = i * A + a;
    k14_track(kq + q * F, feas[q] != 0, cost[q], bk, bc, F);
  }
  k14_store(bk, best_k_out + i * F, F);
  best_cost_out[i] = bc;
  int best = 0;
  for (int a = 1; a < A; ++a)
    if (k14_less_or_nan(merit[i * A + a], a, merit[i * A + best], best)) best = a;
  const float* src = merit[i * A + best] < m0[i] ? kq + (i * A + best) * F : k + i * F;
  k14_store(src, k_out + i * F, F);
}

// outer: a thread per multiplier, lam = max(lam + rho c, 0); the first n
// threads also fold k into the tracker and double rho (at most 1e6)
__global__ void __launch_bounds__(K14_THREADS) k14_outer_kernel(
    const float* k, const unsigned char* feas, const float* cost, const float* c,
    const float* lam, const float* rho, const float* best_k, const float* best_cost,
    float* lam_out, float* rho_out, float* best_k_out, float* best_cost_out, int n, int F,
    int M) {
  const long long j = k14_index();
  if (j < (long long)n * M) {
    const float z = lam[j] + rho[j / M] * c[j];
    lam_out[j] = isnan(z) ? z : fmaxf(z, 0.0f);
  }
  if (j >= n) return;
  const float r = rho[j] * 2.0f;
  rho_out[j] = isnan(r) ? r : fminf(r, 1e6f);
  float bk[K14_MAX_F];
  k14_load(best_k + j * F, bk, F);
  float bc = best_cost[j];
  k14_track(k + j * F, feas[j] != 0, cost[j], bk, bc, F);
  k14_store(bk, best_k_out + j * F, F);
  best_cost_out[j] = bc;
}

// cull: CTA (tile of M, w * keep + r) gathers the carry of the seed ranked
// r-th by score = best_cost where finite, else (1e6 + v) + cost
__global__ void __launch_bounds__(K14_THREADS) k14_cull_kernel(
    const float* k, const float* lam, const float* rho, const float* best_k,
    const float* best_cost, const float* v, const float* cost, float* k_out, float* lam_out,
    float* rho_out, float* best_k_out, float* best_cost_out, int S, int keep, int F, int M) {
  const int w = blockIdx.y / keep, r = blockIdx.y % keep;
  float score[K14_MAX_S];
  for (int s = 0; s < S; ++s) {
    const long long i = (long long)w * S + s;
    const float bc = best_cost[i];
    score[s] = isfinite(bc) ? bc : (1e6f + v[i]) + cost[i];
  }
  int pick = 0;
  for (int s = 0; s < S; ++s) {
    int rank = 0;
    for (int t = 0; t < S; ++t) rank += k14_sort_less(score[t], t, score[s], s) ? 1 : 0;
    if (rank == r) pick = s;
  }
  const long long src = (long long)w * S + pick, dst = (long long)w * keep + r;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m < M) lam_out[dst * M + m] = lam[src * M + m];
  if (blockIdx.x != 0) return;
  if (threadIdx.x < F) {
    k_out[dst * F + threadIdx.x] = k[src * F + threadIdx.x];
    best_k_out[dst * F + threadIdx.x] = best_k[src * F + threadIdx.x];
  }
  if (threadIdx.x == 0) {
    rho_out[dst] = rho[src];
    best_cost_out[dst] = best_cost[src];
  }
}

// pull-in: the bracket [lo, hi] = [best_k where the tracker holds a point
// else k, k] and its midpoint
__global__ void __launch_bounds__(K14_THREADS) k14_pull_start_kernel(
    const float* k, const float* best_k, const float* best_cost, float* lo, float* hi,
    float* mid, int n, int F) {
  const long long i = k14_index();
  if (i >= n) return;
  const bool have = isfinite(best_cost[i]);
  for (int f = 0; f < F; ++f) {
    const float kf = k[i * F + f];
    const float l = have ? best_k[i * F + f] : kf;
    lo[i * F + f] = l;
    hi[i * F + f] = kf;
    mid[i * F + f] = 0.5f * (l + kf);
  }
}

// one bisection step on ok (K8's feasibility of mid), and the next midpoint
__global__ void __launch_bounds__(K14_THREADS) k14_pull_step_kernel(
    const float* lo, const float* hi, const float* mid, const unsigned char* ok, float* lo_out,
    float* hi_out, float* mid_out, int n, int F) {
  const long long i = k14_index();
  if (i >= n) return;
  const bool o = ok[i] != 0;
  for (int f = 0; f < F; ++f) {
    const long long e = i * F + f;
    const float l = o ? mid[e] : lo[e];
    const float h = o ? hi[e] : mid[e];
    lo_out[e] = l;
    hi_out[e] = h;
    mid_out[e] = 0.5f * (l + h);
  }
}

// the last bisection step, then k_pull = lo where k ended infeasible and
// the tracker holds a point, else k
__global__ void __launch_bounds__(K14_THREADS) k14_pull_end_kernel(
    const float* k, const float* lo, const float* mid, const unsigned char* ok,
    const unsigned char* end_feas, const float* best_cost, float* k_pull, int n, int F) {
  const long long i = k14_index();
  if (i >= n) return;
  const bool o = ok[i] != 0;
  const bool pull = !end_feas[i] && isfinite(best_cost[i]);
  for (int f = 0; f < F; ++f) {
    const long long e = i * F + f;
    k_pull[e] = pull ? (o ? mid[e] : lo[e]) : k[e];
  }
}

// finish: fold k_pull into the tracker; kb = [k, best_k] per world
__global__ void __launch_bounds__(K14_THREADS) k14_finish_kernel(
    const float* k, const float* k_pull, const unsigned char* feas, const float* cost,
    const float* best_k, const float* best_cost, float* kb, float* best_cost_out, int n, int S,
    int F) {
  const long long i = k14_index();
  if (i >= n) return;
  const long long w = i / S, s = i % S;
  float bk[K14_MAX_F];
  k14_load(best_k + i * F, bk, F);
  float bc = best_cost[i];
  k14_track(k_pull + i * F, feas[i] != 0, cost[i], bk, bc, F);
  k14_store(k + i * F, kb + (w * 2 * S + s) * F, F);
  k14_store(bk, kb + (w * 2 * S + S + s) * F, F);
  best_cost_out[i] = bc;
}

__device__ __forceinline__ bool k14_viol_ok(const float* v, float t0, float t1, float t2,
                                            float t3) {
  return v[0] <= t0 && v[1] <= t1 && v[2] <= t2 && v[3] <= t3;
}

// select: per seed the final or the best iterate by the full-set
// violations v [W, 2S, 4] of kb, then the world's seed (the feasible one
// of least cost, else the one of least cost)
__global__ void __launch_bounds__(K14_THREADS) k14_select_kernel(
    const float* kb, const float* v, const float* best_cost, const float* cost_final, float t0,
    float t1, float t2, float t3, float* k_out, unsigned char* feasible_out, float* cost_out,
    float* viol_out, int W, int S, int F) {
  const long long w = k14_index();
  if (w >= W) return;
  bool use[K14_MAX_S], feas[K14_MAX_S];
  float cost[K14_MAX_S];
  bool any = false;
  for (int s = 0; s < S; ++s) {
    const long long i = w * S + s;
    const float* vf = v + (w * 2 * S + s) * 4;
    const float* vb = v + (w * 2 * S + S + s) * 4;
    const bool ff = k14_viol_ok(vf, t0, t1, t2, t3);
    const bool fb = k14_viol_ok(vb, t0, t1, t2, t3) && isfinite(best_cost[i]);
    use[s] = fb && (!ff || best_cost[i] < cost_final[i]);
    feas[s] = ff || fb;
    cost[s] = use[s] ? best_cost[i] : cost_final[i];
    any = any || feas[s];
  }
  int pick = 0;
  for (int s = 1; s < S; ++s) {
    const float a = any ? (feas[s] ? cost[s] : INFINITY) : cost[s];
    const float b = any ? (feas[pick] ? cost[pick] : INFINITY) : cost[pick];
    if (k14_less_or_nan(a, s, b, pick)) pick = s;
  }
  const int row = use[pick] ? S + pick : pick;
  const float* ks = kb + (w * 2 * S + row) * F;
  for (int f = 0; f < F; ++f) k_out[w * F + f] = feas[pick] ? ks[f] : __int_as_float(0x7fc00000);
  feasible_out[w] = feas[pick] ? 1 : 0;
  cost_out[w] = cost[pick];
  for (int g = 0; g < 4; ++g) viol_out[w * 4 + g] = v[(w * 2 * S + row) * 4 + g];
}

#define K14_RETURN return (int)cudaGetLastError()

// The launches: blocks from kernels/solver.py:k14_geometry, n = W S.
extern "C" int k14_init(const float* k, const unsigned char* feas, const float* cost,
                        float* best_k, float* best_cost, int n, int F, int blocks, void* stream) {
  k14_init_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(k, feas, cost, best_k,
                                                                     best_cost, n, F);
  K14_RETURN;
}

extern "C" int k14_ladder(const float* k, const float* step, const unsigned char* feas,
                          const float* cost, const float* best_k, const float* best_cost,
                          float* kq, float* best_k_out, float* best_cost_out, int n, int F,
                          int A, const float* alphas, int blocks, void* stream) {
  if (A < 1 || A > K14_MAX_A || F > K14_MAX_F) return (int)cudaErrorInvalidValue;
  K14Alphas al;
  for (int a = 0; a < K14_MAX_A; ++a) al.a[a] = a < A ? alphas[a] : 0.0f;
  k14_ladder_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      k, step, feas, cost, best_k, best_cost, kq, best_k_out, best_cost_out, n, F, A, al);
  K14_RETURN;
}

extern "C" int k14_accept(const float* k, const float* m0, const float* kq, const float* merit,
                          const unsigned char* feas, const float* cost, const float* best_k,
                          const float* best_cost, float* k_out, float* best_k_out,
                          float* best_cost_out, int n, int F, int A, int blocks, void* stream) {
  if (A < 1 || A > K14_MAX_A || F > K14_MAX_F) return (int)cudaErrorInvalidValue;
  k14_accept_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      k, m0, kq, merit, feas, cost, best_k, best_cost, k_out, best_k_out, best_cost_out, n, F, A);
  K14_RETURN;
}

extern "C" int k14_outer(const float* k, const unsigned char* feas, const float* cost,
                         const float* c, const float* lam, const float* rho, const float* best_k,
                         const float* best_cost, float* lam_out, float* rho_out, float* best_k_out,
                         float* best_cost_out, int n, int F, int M, int blocks, void* stream) {
  if (F > K14_MAX_F) return (int)cudaErrorInvalidValue;
  k14_outer_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      k, feas, cost, c, lam, rho, best_k, best_cost, lam_out, rho_out, best_k_out, best_cost_out,
      n, F, M);
  K14_RETURN;
}

extern "C" int k14_cull(const float* k, const float* lam, const float* rho, const float* best_k,
                        const float* best_cost, const float* v, const float* cost, float* k_out,
                        float* lam_out, float* rho_out, float* best_k_out, float* best_cost_out,
                        int W, int S, int keep, int F, int M, int blocks_m, int blocks_wk,
                        void* stream) {
  if (S > K14_MAX_S || keep < 1 || keep > S || F > K14_THREADS || blocks_wk != W * keep)
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)blocks_m, (unsigned int)blocks_wk);
  k14_cull_kernel<<<grid, K14_THREADS, 0, (cudaStream_t)stream>>>(
      k, lam, rho, best_k, best_cost, v, cost, k_out, lam_out, rho_out, best_k_out,
      best_cost_out, S, keep, F, M);
  K14_RETURN;
}

extern "C" int k14_pull_start(const float* k, const float* best_k, const float* best_cost,
                              float* lo, float* hi, float* mid, int n, int F, int blocks,
                              void* stream) {
  k14_pull_start_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(k, best_k, best_cost,
                                                                           lo, hi, mid, n, F);
  K14_RETURN;
}

extern "C" int k14_pull_step(const float* lo, const float* hi, const float* mid,
                             const unsigned char* ok, float* lo_out, float* hi_out,
                             float* mid_out, int n, int F, int blocks, void* stream) {
  k14_pull_step_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(lo, hi, mid, ok, lo_out,
                                                                          hi_out, mid_out, n, F);
  K14_RETURN;
}

extern "C" int k14_pull_end(const float* k, const float* lo, const float* mid,
                            const unsigned char* ok, const unsigned char* end_feas,
                            const float* best_cost, float* k_pull, int n, int F, int blocks,
                            void* stream) {
  k14_pull_end_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(k, lo, mid, ok, end_feas,
                                                                         best_cost, k_pull, n, F);
  K14_RETURN;
}

extern "C" int k14_finish(const float* k, const float* k_pull, const unsigned char* feas,
                          const float* cost, const float* best_k, const float* best_cost,
                          float* kb, float* best_cost_out, int n, int S, int F, int blocks,
                          void* stream) {
  if (F > K14_MAX_F) return (int)cudaErrorInvalidValue;
  k14_finish_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      k, k_pull, feas, cost, best_k, best_cost, kb, best_cost_out, n, S, F);
  K14_RETURN;
}

extern "C" int k14_select(const float* kb, const float* v, const float* best_cost,
                          const float* cost_final, float t0, float t1, float t2, float t3,
                          float* k_out, unsigned char* feasible_out, float* cost_out,
                          float* viol_out, int W, int S, int F, int blocks, void* stream) {
  if (S < 1 || S > K14_MAX_S) return (int)cudaErrorInvalidValue;
  k14_select_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      kb, v, best_cost, cost_final, t0, t1, t2, t3, k_out, feasible_out, cost_out, viol_out, W, S,
      F);
  K14_RETURN;
}
