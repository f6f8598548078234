// K8: ALM merit and feasibility of query points, rows to values.
//
// Replaces the constraint_stack value passes of armour_tpu/nlp.py:494-516
// (the line search, track_best), :517-532 (the multiplier update), :536-543
// (cull_score) and :553-580 (the pull-in bisection and the finalize checks),
// with phi (pz/basis.py:56), the link centres (collision.py:133) and the
// screened collision rows (collision.py:255).  Plain version:
// nlp.py:alm_values_plain.  Per (world, query q) with seed s = seed[q]:
//
//   c = clip(stack(k_q), -1e6)
//   merit = cost(k_q) + sum_r [lam_s + rho_s c > 0] (lam_s + rho_s c)^2 / (2 rho_s)
//   feas = all(c <= thr);  c written when asked
//
// Bound on the H100 (flagship, W = 64, Q = S A = 12): the world's centre
// and torque polynomials and screened rows are read once, ~0.30 GB, ~0.09
// ms at 3.35 TB/s; ~1.2 MFLOP per query, ~0.9 GFLOP, ~0.014 ms at 67
// TFLOP/s: bound by bytes (c, when written, adds 4 M bytes per query).
//
// Design, simple first: one CTA per (world, group of G <= 4 queries), 256
// threads.  phi of the G queries and their link centres at every (time,
// link) cell (3 G T J floats) live in shared memory; a warp per polynomial
// row forms G dot products from one read of the row, a thread per screened
// row reads its 36 normals once for all G queries.  Per query the penalty
// and the count of violated rows are summed per thread in a fixed order and
// reduced in a fixed tree order (no atomics).
#include "alm_rows.cuh"

template <int NF, int G>
__global__ void __launch_bounds__(ALM_THREADS) k8_kernel(const AlmArgs a) {
  extern __shared__ float sm[];
  const int w = blockIdx.y;
  const int q0 = blockIdx.x * G;
  const int nq = min(G, a.Q - q0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TJ = a.TJ, TF = a.TF, K = a.K, B = a.B, M = a.M;
  float* kq = sm;                              // [G][8]
  float* phi = kq + 8 * G;                     // [G][ALM_MAX_B]
  float* p = phi + G * ALM_MAX_B;              // [G][3][TJ]
  float* red = p + 3 * G * TJ;                 // [ALM_WARPS][2 G]

  // queries past the end repeat the last one; their results are not written
  if (tid < G * NF) {
    const int g = tid / NF, f = tid - NF * (tid / NF);
    const int q = q0 + (g < nq ? g : nq - 1);
    kq[g * 8 + f] = a.k[((long long)w * a.Q + q) * NF + f];
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) alm_basis<NF>(a, kq + g * 8, phi + g * ALM_MAX_B, false);
  __syncthreads();

  const float* lam_q[G];
  float rho_q[G];
  float* c_q[G];
  float acc[2 * G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int q = q0 + (g < nq ? g : nq - 1);
    const int s = a.seed[q];
    lam_q[g] = a.lam + ((long long)w * a.S + s) * M;
    rho_q[g] = a.rho[(long long)w * a.S + s];
    c_q[g] = (a.c != nullptr && g < nq) ? a.c + ((long long)w * a.Q + q) * M : nullptr;
    acc[2 * g] = 0.0f;
    acc[2 * g + 1] = 0.0f;
  }
  // one row's clipped value for query g
  auto row = [&](int g, int r, float thr, float c_raw) {
    const float c = alm_clip(c_raw);
    const float z = lam_q[g][r] + rho_q[g] * c;
    acc[2 * g] += z > 0.0f ? z * z : 0.0f;
    acc[2 * g + 1] += (c <= thr) ? 0.0f : 1.0f;
    if (c_q[g] != nullptr) c_q[g][r] = c;
  };

  // link centres at every (time, link) cell
  const float* cw = a.center + (long long)w * 3 * TJ * B;
  for (int r = warp; r < 3 * TJ; r += ALM_WARPS) {
    float v[G];
    alm_warp_dots<G>(cw + (long long)r * B, phi, B, v);
    if (lane == 0) {
      const int cell = r / 3, ax = r - 3 * (r / 3);
#pragma unroll
      for (int g = 0; g < G; ++g) p[(g * 3 + ax) * TJ + cell] = v[g];
    }
  }
  // torque rows: +u - hi, then -u - hi
  const float* uw = a.u_coef + (long long)w * TF * B;
  for (int r = warp; r < TF; r += ALM_WARPS) {
    float v[G];
    alm_warp_dots<G>(uw + (long long)r * B, phi, B, v);
    if (lane == 0) {
      const float hi = a.u_hi[(long long)w * TF + r];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        row(g, r, a.thr_torque, v[g] - hi);
        row(g, TF + r, a.thr_torque, -v[g] - hi);
      }
    }
  }
  __syncthreads();

  // screened collision rows
  const unsigned char* mw = a.mask + (long long)w * K;
  for (int r = tid; r < K; r += ALM_THREADS) {
    float m[G];
    alm_collision<G>(a, w, r, p, m, nullptr, nullptr);
    const bool real = mw[r] != 0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float gval = real ? -m[g] : -ALM_BIG;
      row(g, 2 * TF + r, a.thr_col, gval + a.col_margin);
    }
  }
  // state rows: one thread per (query, factor)
  if (tid < G * NF) {
    const int gq = tid / NF, f = tid - NF * (tid / NF);
    float c8[8], j8[8];
    alm_state_rows(a, w, f, kq[gq * 8 + f], c8, j8);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g != gq) continue;
      for (int grp = 0; grp < 8; ++grp) row(g, 2 * TF + K + grp * NF + f, a.thr_state, c8[grp]);
    }
  }

  alm_block_sum<2 * G>(acc, red);
  if (tid != 0) return;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= nq) continue;
    float kk[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) kk[f] = kq[g * 8 + f];
    const float cost = alm_cost(a, w, kk, nullptr);
    const long long o = (long long)w * a.Q + q0 + g;
    a.value[o] = cost + acc[2 * g] / (2.0f * rho_q[g]);
    a.feas[o] = acc[2 * g + 1] == 0.0f ? 1 : 0;
  }
}

template <int NF, int G>
static int k8_launch_g(const AlmArgs* a, void* stream) {
  const size_t smem = sizeof(float) * (8 * G + G * ALM_MAX_B + 3 * G * (size_t)a->TJ
                                       + ALM_WARPS * 2 * G);
  cudaError_t err = cudaFuncSetAttribute(k8_kernel<NF, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned int)((a->Q + G - 1) / G), (unsigned int)a->W);
  k8_kernel<NF, G><<<grid, ALM_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

template <int NF>
static int k8_launch_nf(const AlmArgs* a, int G, void* stream) {
  switch (G) {
    case 1: return k8_launch_g<NF, 1>(a, stream);
    case 2: return k8_launch_g<NF, 2>(a, stream);
    case 4: return k8_launch_g<NF, 4>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// G: queries per CTA (1, 2 or 4)
extern "C" int k8_launch(const AlmArgs* a, int G, void* stream) {
  switch (a->F) {
    case 7: return k8_launch_nf<7>(a, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
