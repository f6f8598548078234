// K14: the two phases of the ALM solve loop's bookkeeping that keep
// launches of their own; the others run in the finish kernels of the row
// passes K7 and K8 that feed them (alm_loop.cuh, which also says what K14
// replaces and which rules of torch's its phases repeat).
//
//   cull    after the torch sum of the seeds' row violations: CTA (tile of
//           M, w * keep + r) gathers the carry of the seed ranked r-th (each
//           thread ranks the S <= 8 scores itself: no shared memory, no
//           barrier);
//   select  after the full-set check (K4, K8's max mode): a thread per
//           world picks the final or the best iterate of each seed, then
//           the world's seed.
//
// Geometry: kernels/solver.py:k14_geometry.  Bound on the H100: the bytes
// over 3.35 TB/s, a few microseconds at W = 64 (the cull moves the kept
// seeds' [W, keep, M] multipliers, ~3 MB); each phase's time is its launch.
#include "alm_loop.cuh"

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
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
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

// The launches: blocks from kernels/solver.py:k14_geometry.
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
  return (int)cudaGetLastError();
}

extern "C" int k14_select(const float* kb, const float* v, const float* best_cost,
                          const float* cost_final, float t0, float t1, float t2, float t3,
                          float* k_out, unsigned char* feasible_out, float* cost_out,
                          float* viol_out, int W, int S, int F, int blocks, void* stream) {
  if (S < 1 || S > K14_MAX_S) return (int)cudaErrorInvalidValue;
  k14_select_kernel<<<blocks, K14_THREADS, 0, (cudaStream_t)stream>>>(
      kb, v, best_cost, cost_final, t0, t1, t2, t3, k_out, feasible_out, cost_out, viol_out, W, S,
      F);
  return (int)cudaGetLastError();
}
