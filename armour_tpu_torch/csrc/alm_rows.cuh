// Row evaluation of the ALM solver's constraint stack, shared by K7
// (alm_newton.cu) and K8 (alm_values.cu), so that the two cannot drift apart.
// Both call the per-row functions (alm_basis_at / alm_phi, alm_collision,
// alm_state_rows, alm_cost) from their row-tiled grids.
//
// The stack is the one of nlp.py:constraint_stack, in its row order:
//
//   [torque_hi (TF); torque_lo (TF); grasp (TG); collision (K); state (8F)]
//
//   torque    u = u_coef[row] . phi(k),  c = +-u - hi,  dc/dk = +-u_coef[row] . dphi(k)
//   grasp     the contact rows of a grasp plan (TG = 3 T, else 0; grasp.py):
//             c = g_coef[row] . phi(k) + g_rad[row],  dc/dk = g_coef[row] . dphi(k),
//             the torque rows' arithmetic without the limit
//   collision K4's rule (collision_rows.cu) at the link centre p = center[cell] . phi(k)
//             of the row's (time, link) cell, plus collision_search_margin; in
//             the smooth mode (tau > 0) K4's log-sum-exp and its blended normal
//             (collision_rule.cuh, one copy for K4 / K7 / K8), a template flag
//             of the kernels that call it
//   state     the position / velocity extrema over the whole trajectory
//             against the margin-tightened limits, each row's gradient one
//             entry: the Bezier family's (bezier.py:q_extrema_in_k,
//             qd_extrema_in_k) or, when armtd is set, the constant-
//             acceleration family's (armtd.py:armtd_position_extrema,
//             armtd_velocity_extrema); the family is uniform per launch
//
// Every row is clipped at -1e6 (padded rows sit at -BIG) before it meets
// the multipliers.  The float32 arithmetic repeats the plain PyTorch
// version's operation by operation where a verdict rests on it (the
// extrema's root tests, K4's argmax); the 120-term dot products are summed
// in another order than torch.matmul's, so values agree to rounding.
//
// Built without fast math and with -fmad=false: IEEE division and sqrtf,
// no contraction into fused multiply-adds.
#pragma once
#include <cuda_runtime.h>

#include "alm_loop.cuh"
#include "collision_rule.cuh"

#define ALM_MAX_B 128
#define ALM_MAX_F 8
#define ALM_MAX_DEG 3
#define ALM_BIG 1e8f
#define ALM_CLIP (-1e6f)
#define ALM_FULL 0xffffffffu

struct AlmArgs {
  const float* u_coef;              // [W, TF, B] nominal torque polynomials
  const float* u_hi;                // [W, TF] torque limit minus the robust radius
  const float* g_coef;              // [W, TG, B] grasp row polynomials (row t 3 + sep/slip/tip)
  const float* g_rad;               // [W, TG] their non-k radius
  const float* center;              // [W, TJ * 3, B] link-centre polynomials
  const float* A;                   // [W, 3, C, K] screened rows' unit normals
  const float* d;                   // [W, C, K]
  const float* delta;               // [W, C, K]
  const int* row;                   // [W, K] (time, link) cell of each screened row
  const unsigned char* mask;        // [W, K] real obstacle
  const float* traj;                // [W, 5, F]: q0, Tqd0 (ARMTD: qd0), TTqdd0, k_scale, q_des
  const float* limits;              // [6, F]: pos_lb, pos_ub, vel_ub, margin-tightened, then
                                    // the same untightened (K8's max mode)
  const unsigned char* continuous;  // [F]
  const float* k;                   // [W, Q, F] query points
  const float* lam;                 // [W, S, M] multipliers
  const float* rho;                 // [W, S] penalty weights
  const int* seed;                  // [Q] seed of each query (K8)
  float* value;                     // [W, Q]: K7 m0, K8 merit
  unsigned char* feas;              // [W, Q]: every row within its threshold
  float* step;                      // K7 [W, Q, F]
  float* g;                         // K7 [W, Q, F] or null
  float* H;                         // K7 [W, Q, F, F] or null
  float* c;                         // K8 [W, Q, M] or null
  float* cost;                      // [W, Q] the cost at each query, or null
  float* vmax;                      // K8's max mode: [W, Q, 3] torque, state and grasp maxima
  int W, Q, S, M, TF, TJ, C, K, B, F;
  int TG;                           // grasp rows, 3 T or 0
  int armtd;                        // 1: the constant-acceleration family
  int maxima;                       // 1: K8's max mode (max_violations' torque and state rows)
  float cost_scale;                 // cfg.cost_scale
  float kw;                         // d q_plan / d k_actual at t_plan (ARMTD: 0.5 tp^2)
  float qb0, qb1, qb2, qb3;         // q_des's Bernstein weights at t_plan (b3+b4+b5 last)
  float two_pi, pi;                 // the wrap's constants, as float32
  float dur;                        // duration
  float thr_torque, thr_col, thr_state, col_margin, thr_grasp;
  float tp, dts;                    // ARMTD: t_plan and duration - t_plan
  float g_tp, g_ts;                 // ARMTD: dq/dk_actual at t_plan and at duration
  float tau;                        // > 0: the smooth collision mode (cfg.smooth_tau)
  float tau_log2c;                  // tau log(2C), rounded as the plain version rounds it
  unsigned char degs[ALM_MAX_B * ALM_MAX_F];   // [B, F] monomial degrees
  AlmEpilogue epi;                  // the loop's phase the finish runs (K7 / K8), or none
};

// ---------------------------------------------------------------------------
// the monomial basis: phi(k) [B] and dphi/dk [F][B] (pz/basis.py:phi, dphi)
// ---------------------------------------------------------------------------

// k^e for e <= ALM_MAX_DEG as the product 1 * k * ... * k taken in order
// (1 * k = k exactly), chosen without an indexed table.
__device__ __forceinline__ float alm_power(float k, float k2, float k3, int e) {
  return e == 0 ? 1.0f : e == 1 ? k : e == 2 ? k2 : k3;
}

// The factors of monomial b (degrees dg [NF]), take[i] = k_i^deg(b, i);
// phi_b is their product in factor order.
template <int NF>
__device__ __forceinline__ float alm_phi(const unsigned char* dg, const float* k, float* take) {
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    const float k2 = k[i] * k[i];
    take[i] = alm_power(k[i], k2, k2 * k[i], dg[i]);
  }
  float phi = take[0];
#pragma unroll
  for (int i = 1; i < NF; ++i) phi = phi * take[i];
  return phi;
}

// phi_b and its k-gradient at k [NF]: out[0] = phi_b, out[(1 + f) * stride] =
// d phi_b / d k_f (dg: monomial b's degrees)
template <int NF>
__device__ __forceinline__ void alm_basis_at(const unsigned char* dg, const float* k, float* out,
                                             int stride) {
  float take[NF];
  out[0] = alm_phi<NF>(dg, k, take);
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int dj = dg[j];
    const float k2 = k[j] * k[j];
    const float dcol = (float)dj * alm_power(k[j], k2, k2 * k[j], dj > 0 ? dj - 1 : 0);
    float others = 1.0f;
    bool first = true;
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      if (i == j) continue;
      others = first ? take[i] : others * take[i];
      first = false;
    }
    out[(1 + j) * stride] = dcol * others;
  }
}

// NV dot products of one coefficient row (B floats, global) with the
// vectors vec[v * ALM_MAX_B + b] in shared memory, lanes over b, summed by a
// butterfly: every lane returns the same sums.
template <int NV>
__device__ __forceinline__ void alm_warp_dots(const float* __restrict__ row, const float* vec,
                                              int B, float* out) {
  const int lane = threadIdx.x & 31;
  float s[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) s[v] = 0.0f;
  for (int b = lane; b < B; b += 32) {
    const float x = __ldg(row + b);
#pragma unroll
    for (int v = 0; v < NV; ++v) s[v] += x * vec[v * ALM_MAX_B + b];
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s[v] += __shfl_xor_sync(ALM_FULL, s[v], off);
    out[v] = s[v];
  }
}

// ---------------------------------------------------------------------------
// collision rows: K4's rule (collision_rows.cu)
// ---------------------------------------------------------------------------

// K4's hard rule (collision_rule.cuh, shared with K4, without K4's NaN
// order) for screened row r of world w at G link centres (p0, p1, p2)[g]:
// m[g] = max over the 2C candidates (first maximal, pos before neg), and,
// when comb is given, the chosen normal and sign.
template <int G>
__device__ __forceinline__ void alm_collision_at(const AlmArgs& a, int w, int r, const float* p0,
                                                 const float* p1, const float* p2, float* m,
                                                 int* comb, float* sign) {
  const long long K = a.K;
  const int C = a.C;
  collision_hard_rule<G, false>(a.A + (long long)w * 3 * C * K, a.d + (long long)w * C * K,
                                a.delta + (long long)w * C * K, K, C, r, p0, p1, p2, m, comb,
                                sign);
}

// The smooth mode's rule (collision_rule.cuh, shared with K4) for screened
// row r of world w at G link centres: m[g] and, when gp0 is given, the
// blended normal's dm/dp negated in gp0 / gp1 / gp2.
template <int G>
__device__ __forceinline__ void alm_collision_smooth_at(const AlmArgs& a, int w, int r,
                                                        const float* p0, const float* p1,
                                                        const float* p2, float* m, float* gp0,
                                                        float* gp1, float* gp2) {
  const long long K = a.K;
  const int C = a.C;
  collision_smooth_rule<G>(a.A + (long long)w * 3 * C * K, a.d + (long long)w * C * K,
                           a.delta + (long long)w * C * K, K, C, r, a.tau, a.tau_log2c, p0, p1,
                           p2, m, gp0, gp1, gp2);
}

// The same (SMOOTH: the smooth rule's m alone) at the link centres
// p[(g * 3 + a) * TJ + cell] of the row's (time, link) cell; returns the cell.
template <int G, bool SMOOTH = false>
__device__ __forceinline__ int alm_collision(const AlmArgs& a, int w, int r, const float* p,
                                             float* m, int* comb, float* sign) {
  const int TJ = a.TJ;
  const int cell = a.row[(long long)w * a.K + r];
  float p0[G], p1[G], p2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    p0[g] = p[(g * 3 + 0) * TJ + cell];
    p1[g] = p[(g * 3 + 1) * TJ + cell];
    p2[g] = p[(g * 3 + 2) * TJ + cell];
  }
  if constexpr (SMOOTH)
    alm_collision_smooth_at<G>(a, w, r, p0, p1, p2, m, nullptr, nullptr, nullptr);
  else
    alm_collision_at<G>(a, w, r, p0, p1, p2, m, comb, sign);
  return cell;
}

// ---------------------------------------------------------------------------
// state rows: trajectory extrema (nlp.py:joint_position_extrema,
// joint_velocity_extrema; bezier.py), the plain version's operations
// ---------------------------------------------------------------------------

__device__ __forceinline__ float alm_pow(float x, int e) {
  // torch.pow: x*x for 2, x*x*x for 3, pow otherwise
  if (e == 2) return x * x;
  if (e == 3) return x * x * x;
  return powf(x, (float)e);
}

__device__ __forceinline__ float alm_q_des(float q0, float T, float TT, float ka, float s) {
  const float sm1 = s - 1.0f;
  const float b0 = -alm_pow(sm1, 5);
  const float b1 = (5.0f * s) * alm_pow(sm1, 4);
  const float b2 = (-10.0f * alm_pow(s, 2)) * alm_pow(sm1, 3);
  const float b3 = (10.0f * alm_pow(s, 3)) * alm_pow(sm1, 2);
  const float b4 = (-5.0f * alm_pow(s, 4)) * sm1;
  const float b5 = alm_pow(s, 5);
  const float beta1 = q0 + T / 5.0f;
  const float beta2 = (q0 + (2.0f * T) / 5.0f) + TT / 20.0f;
  const float beta3 = q0 + ka;
  return ((b0 * q0 + b1 * beta1) + b2 * beta2) + ((b3 + b4) + b5) * beta3;
}

__device__ __forceinline__ float alm_qd_des(float q0, float T, float TT, float ka, float s) {
  const float sm1 = s - 1.0f;
  const float db0 = -5.0f * alm_pow(sm1, 4);
  const float db1 = (20.0f * s) * alm_pow(sm1, 3) + 5.0f * alm_pow(sm1, 4);
  const float db2 = (-20.0f * s) * alm_pow(sm1, 3) - (30.0f * alm_pow(s, 2)) * alm_pow(sm1, 2);
  const float db3 = (10.0f * alm_pow(s, 3)) * (2.0f * s - 2.0f)
                    + (30.0f * alm_pow(s, 2)) * alm_pow(sm1, 2);
  const float db4 = (-20.0f * alm_pow(s, 3)) * sm1 - 5.0f * alm_pow(s, 4);
  const float db5 = 5.0f * alm_pow(s, 4);
  const float beta1 = q0 + T / 5.0f;
  const float beta2 = (q0 + (2.0f * T) / 5.0f) + TT / 20.0f;
  const float beta3 = q0 + ka;
  return ((db0 * q0 + db1 * beta1) + db2 * beta2) + ((db3 + db4) + db5) * beta3;
}

__device__ __forceinline__ bool alm_root_ok(bool valid, float e, float v) {
  return valid && (0.0f <= e) && (e <= 1.0f) && isfinite(e) && isfinite(v);
}

// min / max over the candidates [v0, v1, v2, v3] inside (first index on
// ties, as torch.argmin / argmax) and the gradients there
__device__ __forceinline__ void alm_select(const float* v, const float* gr, const bool* in,
                                           float* lo, float* hi, float* glo, float* ghi) {
  int ilo = 0, ihi = 0;
  float vlo = in[0] ? v[0] : ALM_BIG, vhi = in[0] ? v[0] : -ALM_BIG;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const float xl = in[i] ? v[i] : ALM_BIG;
    const float xh = in[i] ? v[i] : -ALM_BIG;
    if (xl < vlo) { vlo = xl; ilo = i; }
    if (xh > vhi) { vhi = xh; ihi = i; }
  }
  *lo = vlo;
  *hi = vhi;
  *glo = gr[ilo];
  *ghi = gr[ihi];
}

// The ARMTD family's 8 state rows (armtd.py:armtd_position_extrema,
// armtd_velocity_extrema, operation for operation): position candidates
// q0, q(t_plan), q(duration) and the phase-1 vertex at t* = -qd0 / k_act
// where it lies in (0, t_plan); velocity candidates qd0, the peak qd0 + k_act
// t_plan and 0, already in rad/s (no 1 / duration).  traj's row 1 holds qd0.
__device__ void alm_armtd_state_rows(const AlmArgs& a, const float* lim, int w, int f, float kf,
                                     float* c, float* jf) {
  const int F = a.F;
  const float* tr = a.traj + (long long)w * 5 * F;
  const float q0 = tr[f], qd0 = tr[F + f], kr = tr[3 * F + f];
  const float tp = a.tp;
  const float ka = kf * kr;
  const float qd_pk = qd0 + ka * tp;
  float v[4], gr[4], lo, hi, glo, ghi;
  bool in[4] = {true, true, true, false};

  v[0] = q0;
  v[1] = (q0 + qd0 * tp) + ((0.5f * ka) * tp) * tp;
  v[2] = v[1] + (0.5f * qd_pk) * a.dts;
  const bool nonzero = fabsf(ka) > 1e-12f;
  const float ts = nonzero ? (-qd0) / ka : -1.0f;
  v[3] = (q0 + qd0 * ts) + ((0.5f * ka) * ts) * ts;
  in[3] = (0.0f < ts) && (ts < tp);
  gr[0] = 0.0f;
  gr[1] = a.g_tp;
  gr[2] = a.g_ts;
  gr[3] = (0.5f * ts) * ts;
  alm_select(v, gr, in, &lo, &hi, &glo, &ghi);
  const float lb = lim[f], ub = lim[F + f];
  float gl = glo * kr, gh = ghi * kr;
  c[0] = lb - lo;  jf[0] = -gl;
  c[1] = lo - ub;  jf[1] = gl;
  c[2] = lb - hi;  jf[2] = -gh;
  c[3] = hi - ub;  jf[3] = gh;

  v[0] = qd0;
  v[1] = qd_pk;
  v[2] = 0.0f;
  gr[0] = 0.0f;
  gr[1] = tp;
  gr[2] = 0.0f;
  in[3] = false;
  alm_select(v, gr, in, &lo, &hi, &glo, &ghi);
  const float vub = lim[2 * F + f];
  gl = glo * kr;
  gh = ghi * kr;
  c[4] = -vub - lo;  jf[4] = -gl;
  c[5] = lo - vub;   jf[5] = gl;
  c[6] = -vub - hi;  jf[6] = -gh;
  c[7] = hi - vub;   jf[7] = gh;
}

// The 8 state rows of factor f at k_f: c[8] in the stack's order
// (pos_min lo/hi, pos_max lo/hi, vel_min lo/hi, vel_max lo/hi) and the one
// non-zero gradient entry of each, jf[8], against the limits lim [3, F]
// (a.limits: margin-tightened; a.limits + 3 F: untightened).
__device__ void alm_state_rows(const AlmArgs& a, const float* lim, int w, int f, float kf,
                               float* c, float* jf) {
  if (a.armtd) {
    alm_armtd_state_rows(a, lim, w, f, kf, c, jf);
    return;
  }
  const int F = a.F;
  const float* tr = a.traj + (long long)w * 5 * F;
  const float q0 = tr[f], T = tr[F + f], TT = tr[2 * F + f], kr = tr[3 * F + f];
  const float ka = kf * kr;
  float v[4], gr[4], lo, hi, glo, ghi;
  bool in[4] = {true, true, false, false};

  // position: q_extrema_in_k
  {
    const float den = 5.0f * ((6.0f * T - 12.0f * ka) + TT);
    const float disc_sq = ((64.0f * (T * T) + (14.0f * T) * TT) - (120.0f * ka) * T) + TT * TT;
    const float disc = sqrtf(disc_sq < 0.0f ? 0.0f : disc_sq);
    const bool valid = disc_sq >= 0.0f;
    const float num = 2.0f * T + TT;
    const float e2 = (num + disc) / den, e3 = (num - disc) / den;
    v[0] = alm_q_des(q0, T, TT, ka, 0.0f);
    v[1] = alm_q_des(q0, T, TT, ka, 1.0f);
    v[2] = alm_q_des(q0, T, TT, ka, e2);
    v[3] = alm_q_des(q0, T, TT, ka, e3);
    gr[0] = 0.0f;
    gr[1] = 1.0f;
    gr[2] = alm_pow(e2, 3) * ((6.0f * alm_pow(e2, 2) - 15.0f * e2) + 10.0f);
    gr[3] = alm_pow(e3, 3) * ((6.0f * alm_pow(e3, 2) - 15.0f * e3) + 10.0f);
    in[2] = alm_root_ok(valid, e2, v[2]);
    in[3] = alm_root_ok(valid, e3, v[3]);
    alm_select(v, gr, in, &lo, &hi, &glo, &ghi);
    const float lb = lim[f], ub = lim[F + f];
    const float gl = glo * kr, gh = ghi * kr;
    c[0] = lb - lo;  jf[0] = -gl;
    c[1] = lo - ub;  jf[1] = gl;
    c[2] = lb - hi;  jf[2] = -gh;
    c[3] = hi - ub;  jf[3] = gh;
  }
  // velocity: qd_extrema_in_k
  {
    const float den = 10.0f * ((6.0f * T - 12.0f * ka) + TT);
    const float disc_sq = 6.0f * (((((150.0f * (ka * ka) - (180.0f * ka) * T) - (20.0f * ka) * TT)
                                    + 54.0f * (T * T)) + (14.0f * T) * TT) + TT * TT);
    const float disc = sqrtf(disc_sq < 0.0f ? 0.0f : disc_sq);
    const bool valid = disc_sq >= 0.0f;
    const float num = ((18.0f * T - 30.0f * ka) + 4.0f * TT);
    const float e2 = (num + disc) / den, e3 = (num - disc) / den;
    v[0] = alm_qd_des(q0, T, TT, ka, 0.0f);
    v[1] = alm_qd_des(q0, T, TT, ka, 1.0f);
    v[2] = alm_qd_des(q0, T, TT, ka, e2);
    v[3] = alm_qd_des(q0, T, TT, ka, e3);
    gr[0] = 0.0f;
    gr[1] = 0.0f;
    gr[2] = (30.0f * alm_pow(e2, 2)) * alm_pow(e2 - 1.0f, 2);
    gr[3] = (30.0f * alm_pow(e3, 2)) * alm_pow(e3 - 1.0f, 2);
    in[2] = alm_root_ok(valid, e2, v[2]);
    in[3] = alm_root_ok(valid, e3, v[3]);
    alm_select(v, gr, in, &lo, &hi, &glo, &ghi);
    const float vub = lim[2 * F + f];
    const float lo_v = lo / a.dur, hi_v = hi / a.dur;
    const float gl = (glo * kr) / a.dur, gh = (ghi * kr) / a.dur;
    c[4] = -vub - lo_v;  jf[4] = -gl;
    c[5] = lo_v - vub;   jf[5] = gl;
    c[6] = -vub - hi_v;  jf[6] = -gh;
    c[7] = hi_v - vub;   jf[7] = gh;
  }
}

// ---------------------------------------------------------------------------
// cost (nlp.py:plan_cost, plan_cost_grad)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float alm_wrap(const AlmArgs& a, float x) {
  // torch.remainder(x + pi, 2 pi) - pi
  const float y = x + a.pi;
  float mod = fmodf(y, a.two_pi);
  if (mod != 0.0f && ((a.two_pi < 0.0f) != (mod < 0.0f))) mod += a.two_pi;
  return mod - a.pi;
}

// cost at k [F] and, when grad is given, d cost / d k [F] (nlp.py:_plan_diff,
// either family; d q_plan / d k = kw k_scale)
__device__ float alm_cost(const AlmArgs& a, int w, const float* k, float* grad) {
  const int F = a.F;
  const float* tr = a.traj + (long long)w * 5 * F;
  float sum = 0.0f;
  for (int f = 0; f < F; ++f) {
    const float q0 = tr[f], T = tr[F + f], TT = tr[2 * F + f], kr = tr[3 * F + f];
    const float qd = tr[4 * F + f];
    float qp;
    if (a.armtd) {
      // q0 + qd0 tp + 0.5 k_act tp^2 (row 1 holds qd0)
      qp = (q0 + T * a.tp) + ((0.5f * (k[f] * kr)) * a.tp) * a.tp;
    } else {
      const float beta1 = q0 + T / 5.0f;
      const float beta2 = (q0 + (2.0f * T) / 5.0f) + TT / 20.0f;
      const float beta3 = q0 + k[f] * kr;
      qp = ((a.qb0 * q0 + a.qb1 * beta1) + a.qb2 * beta2) + a.qb3 * beta3;
    }
    float diff = qp - qd;
    if (a.continuous[f]) diff = alm_wrap(a, diff);
    sum = sum + diff * diff;
    if (grad != nullptr) grad[f] = (a.cost_scale * (2.0f * diff)) * (a.kw * kr);
  }
  return a.cost_scale * sum;
}

// ---------------------------------------------------------------------------
// block reduction in a fixed order (no atomics: repeated calls give the same bits)
// ---------------------------------------------------------------------------

// Sums acc[0..n) over a block of NW warps; thread 0 returns the totals in
// acc.  red: NW * n floats of shared memory.
template <int N, int NW>
__device__ void alm_block_sum(float* acc, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(ALM_FULL, v, off);
    if (lane == 0) red[warp * N + i] = v;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float s = red[i];
      for (int wp = 1; wp < NW; ++wp) s += red[wp * N + i];
      acc[i] = s;
    }
  }
}

// torch.amax's pairwise maximum: NaN propagates
__device__ __forceinline__ float alm_max(float m, float x) { return (isnan(m) || m > x) ? m : x; }

__device__ __forceinline__ float alm_clip(float c) {
  // torch.clamp(c, min=-1e6): NaN stays NaN
  return c < ALM_CLIP ? ALM_CLIP : c;
}

__device__ __forceinline__ int alm_lin(int i, int j) {
  // lower-triangle index of (i >= j)
  return i * (i + 1) / 2 + j;
}

// floats per staged row and per basis vector: B rounded up to a multiple of
// 4 with an odd number of float4s, so that a warp's float4 reads of 32 rows
// fall on distinct banks
static __host__ __device__ __forceinline__ int alm_pitch(int B) {
  int p = (B + 3) / 4 * 4;
  if ((p / 4) % 2 == 0) p += 4;
  return p;
}

// 16-byte asynchronous copy from device to shared memory (cp.async), and
// the wait for all of a thread's copies
__device__ __forceinline__ void alm_cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void alm_cp_wait() { asm volatile("cp.async.wait_all;" ::: "memory"); }

