// K7: one projected Gauss-Newton step of the ALM solver, rows to step.
//
// Replaces armour_tpu/nlp.py:475-493 (inner_step up to the line search):
// constraint_stack (nlp.py:189-254) with its Jacobian, phi/dphi
// (pz/basis.py:56,74), the link centres (collision.py:133,143), the
// screened collision rows (collision.py:255,305) and cho_solve.  Plain
// version: nlp.py:alm_newton_plain.  Per (world, seed):
//
//   c = clip(stack(k), -1e6),  z = lam + rho c,  active = z > 0
//   g = grad cost + sum_r J_r max(z_r, 0)
//   H = sum_r (J_r rho [active]) J_r^T + Hc + 1e-3 I          (lower triangle)
//   step = H^-1 g (7x7 Cholesky),  m0 = cost + sum_r [active] z_r^2 / (2 rho)
//   feas = all(c <= thr)
//
// over the M = 2 T F + K + 8 F rows, without writing the Jacobian.
//
// Bound on the H100 (flagship, W = 64, S = 4): a pass must read each
// world's centre polynomials (1.29 MB), torque polynomials (0.43 MB) and
// screened rows (2.95 MB) once, ~0.30 GB, ~0.09 ms at 3.35 TB/s; ~7 MFLOP
// per (world, seed), ~1.8 GFLOP, ~0.03 ms at 67 TFLOP/s: bound by bytes.
//
// Design, simple first: one CTA per (world, seed), 256 threads.  phi and
// dphi (120 x 8 floats) and the link centres with their k-gradients at
// every (time, link) cell (3 x 8 x T J floats, ~86 KB at T J = 896) live in
// shared memory; a warp per polynomial row forms its 8 dot products; a
// thread per screened row runs K4's rule and chains its gradient.  Each
// thread accumulates g (F), the lower triangle of H (F (F + 1) / 2), the
// penalty and the count of violated rows over its rows in a fixed order;
// one block reduction in a fixed tree order (no atomics) gives the totals,
// and thread 0 factors H and solves.  The seeds of a world re-read its
// coefficients through L2.
#include "alm_rows.cuh"

// accumulate one row: c (unclipped), gradient J [NF]
template <int NF>
__device__ __forceinline__ void k7_row(const AlmArgs& a, const float* lam_s, float rho, int r,
                                       float thr, float c_raw, const float* J, float* acc) {
  const float c = alm_clip(c_raw);
  const float z = lam_s[r] + rho * c;
  const bool act = z > 0.0f;
  const float w = act ? rho : 0.0f;
  const float le = act ? z : 0.0f;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    acc[i] += J[i] * le;
    const float Jw = J[i] * w;
#pragma unroll
    for (int j = 0; j <= i; ++j) acc[NF + alm_lin(i, j)] += Jw * J[j];
  }
  acc[NF + NF * (NF + 1) / 2] += act ? z * z : 0.0f;
  acc[NF + NF * (NF + 1) / 2 + 1] += (c <= thr) ? 0.0f : 1.0f;
}

template <int NF>
__global__ void __launch_bounds__(ALM_THREADS) k7_kernel(const AlmArgs a) {
  constexpr int NV = 1 + NF;
  constexpr int NT = NF * (NF + 1) / 2;
  constexpr int NACC = NF + NT + 2;
  extern __shared__ float sm[];
  const int s = blockIdx.x, w = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TJ = a.TJ, TF = a.TF, K = a.K, B = a.B;
  float* kq = sm;                              // [8]
  float* basis = kq + 8;                       // [NV][ALM_MAX_B]
  float* p = basis + NV * ALM_MAX_B;           // [3][TJ]
  float* dp = p + 3 * TJ;                      // [3][NF][TJ]
  float* red = dp + 3 * NF * TJ;               // [ALM_WARPS][NACC]

  if (tid < NF) kq[tid] = a.k[((long long)w * a.Q + s) * NF + tid];
  __syncthreads();
  alm_basis<NF>(a, kq, basis, true);
  __syncthreads();

  const float* lam_s = a.lam + ((long long)w * a.S + s) * a.M;
  const float rho = a.rho[(long long)w * a.S + s];
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

  // link centres and their gradients at every (time, link) cell
  const float* cw = a.center + (long long)w * 3 * TJ * B;
  for (int r = warp; r < 3 * TJ; r += ALM_WARPS) {
    float v[NV];
    alm_warp_dots<NV>(cw + (long long)r * B, basis, B, v);
    if (lane == 0) {
      const int cell = r / 3, ax = r - 3 * (r / 3);
      p[ax * TJ + cell] = v[0];
#pragma unroll
      for (int f = 0; f < NF; ++f) dp[(ax * NF + f) * TJ + cell] = v[1 + f];
    }
  }
  // torque rows: +u - hi, then -u - hi
  const float* uw = a.u_coef + (long long)w * TF * B;
  for (int r = warp; r < TF; r += ALM_WARPS) {
    float v[NV];
    alm_warp_dots<NV>(uw + (long long)r * B, basis, B, v);
    if (lane == 0) {
      const float hi = a.u_hi[(long long)w * TF + r];
      float J[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) J[f] = v[1 + f];
      k7_row<NF>(a, lam_s, rho, r, a.thr_torque, v[0] - hi, J, acc);
#pragma unroll
      for (int f = 0; f < NF; ++f) J[f] = -v[1 + f];
      k7_row<NF>(a, lam_s, rho, TF + r, a.thr_torque, -v[0] - hi, J, acc);
    }
  }
  __syncthreads();

  // screened collision rows
  const unsigned char* mw = a.mask + (long long)w * K;
  const float* Aw = a.A + (long long)w * 3 * a.C * K;
  for (int r = tid; r < K; r += ALM_THREADS) {
    float m;
    int comb;
    float sign;
    const int cell = alm_collision<1>(a, w, r, p, &m, &comb, &sign);
    const bool real = mw[r] != 0;
    const float g0 = real ? sign * Aw[(0 * a.C + comb) * K + r] : 0.0f;
    const float g1 = real ? sign * Aw[(1 * a.C + comb) * K + r] : 0.0f;
    const float g2 = real ? sign * Aw[(2 * a.C + comb) * K + r] : 0.0f;
    float J[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      J[f] = g0 * dp[(0 * NF + f) * TJ + cell] + g1 * dp[(1 * NF + f) * TJ + cell]
             + g2 * dp[(2 * NF + f) * TJ + cell];
    }
    const float gval = real ? -m : -ALM_BIG;
    k7_row<NF>(a, lam_s, rho, 2 * TF + r, a.thr_col, gval + a.col_margin, J, acc);
  }
  // state rows: one thread per factor
  if (tid < NF) {
    float c8[8], j8[8];
    alm_state_rows(a, w, tid, kq[tid], c8, j8);
    for (int grp = 0; grp < 8; ++grp) {
      float J[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) J[f] = (f == tid) ? j8[grp] : 0.0f;
      k7_row<NF>(a, lam_s, rho, 2 * TF + K + grp * NF + tid, a.thr_state, c8[grp], J, acc);
    }
  }

  alm_block_sum<NACC>(acc, red);
  if (tid != 0) return;

  float kk[NF], gc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) kk[f] = kq[f];
  const float cost = alm_cost(a, w, kk, gc);
  const float* tr = a.traj + (long long)w * 5 * NF;
  float gv[NF], L[NF][NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    gv[i] = gc[i] + acc[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float h = acc[NF + alm_lin(i, j)];
      if (i == j) {
        const float wi = a.kw * tr[3 * NF + i];
        h = (h + ((2.0f * a.cost_scale) * wi) * wi) + 1e-3f;
      }
      L[i][j] = h;
    }
  }
  const long long o = (long long)w * a.Q + s;
  if (a.g != nullptr) {
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      a.g[o * NF + i] = gv[i];
#pragma unroll
      for (int j = 0; j < NF; ++j) a.H[(o * NF + i) * NF + j] = i >= j ? L[i][j] : L[j][i];
    }
  }
  // Cholesky H = L L^T in place (lower triangle), then L y = g, L^T x = y
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    float dsum = L[j][j];
#pragma unroll
    for (int t = 0; t < j; ++t) dsum -= L[j][t] * L[j][t];
    const float ljj = sqrtf(dsum);
    L[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < NF; ++i) {
      float v = L[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) v -= L[i][t] * L[j][t];
      L[i][j] = v / ljj;
    }
  }
  float y[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float v = gv[i];
#pragma unroll
    for (int t = 0; t < i; ++t) v -= L[i][t] * y[t];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = NF - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int t = i + 1; t < NF; ++t) v -= L[t][i] * y[t];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) a.step[o * NF + i] = y[i];
  a.value[o] = cost + acc[NF + NT] / (2.0f * rho);
  a.feas[o] = acc[NF + NT + 1] == 0.0f ? 1 : 0;
}

template <int NF>
static int k7_launch_nf(const AlmArgs* a, void* stream) {
  const size_t smem = sizeof(float) * (8 + (1 + NF) * ALM_MAX_B + 3 * (size_t)a->TJ
                                       + 3 * NF * (size_t)a->TJ
                                       + ALM_WARPS * (NF + NF * (NF + 1) / 2 + 2));
  cudaError_t err = cudaFuncSetAttribute(k7_kernel<NF>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned int)a->Q, (unsigned int)a->W);
  k7_kernel<NF><<<grid, ALM_THREADS, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" int k7_launch(const AlmArgs* a, void* stream) {
  switch (a->F) {
    case 7: return k7_launch_nf<7>(a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
