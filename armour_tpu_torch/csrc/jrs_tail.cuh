// The per-element tail of an online joint reachable set, shared by the JRS
// kernels: the first-order Taylor of cos / sin with an interval Lagrange
// remainder (jrs.py:trig_taylor_pz, pz/interval.py), a joint's four
// rotation matrices (jrs.py:assemble_rotations: centre, k coefficient and
// the cos / sin error generators), and a block's write of one (world, time)
// slab of R and of the three velocity PZs (jrs.py:make_velocity_pz) in the
// port's layouts.  A family's kernel supplies the per-element scalars
// (centre angle, its radius and k coefficient; velocity and acceleration
// centres, k coefficients and radii) and calls these.
//
// The float32 arithmetic repeats the plain PyTorch version operation by
// operation (no fused multiply-adds: the library is built with -fmad=false);
// cosf / sinf are CUDA's IEEE-accurate functions (no fast math), the
// functions torch.cos / torch.sin call on the card.
#pragma once
#include <cuda_runtime.h>

#define JRS_MAXJ 10         // joints + 1 (the end-effector identity)
#define JRS_MAXF 8          // actuated factors

// pz/interval.py's constants, Python doubles rounded once to float32
struct JrsTrig {
  float two_pi, pi, half_pi, neg_half_pi;
};

__device__ __forceinline__ float jrs_min(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float jrs_max(float a, float b) { return b > a ? b : a; }

// interval.py:_contains_multiple: does [lo, hi] hold offset + period * n?
__device__ __forceinline__ bool jrs_contains(float lo, float hi, float period, float offset) {
  const float n = ceilf((lo - offset) / period);
  return offset + n * period <= hi;
}

// interval.py:scale, (lo, hi) * s
__device__ __forceinline__ void jrs_scale(float lo, float hi, float s, float* olo, float* ohi) {
  const bool pos = s >= 0.0f;
  *olo = pos ? lo * s : hi * s;
  *ohi = pos ? hi * s : lo * s;
}

// interval.py:mul of (lo, hi) with (0, w2)
__device__ __forceinline__ void jrs_mul_pow(float lo, float hi, float w2, float* olo,
                                            float* ohi) {
  const float p1 = lo * 0.0f, p2 = lo * w2, p3 = hi * 0.0f, p4 = hi * w2;
  *olo = jrs_min(jrs_min(p1, p2), jrs_min(p3, p4));
  *ohi = jrs_max(jrs_max(p1, p2), jrs_max(p3, p4));
}

// jrs.py:trig_taylor_pz for one element: out = (cos_c, cos_k, cos_e,
// sin_c, sin_k, sin_e)
__device__ __forceinline__ void jrs_trig_taylor(float qc, float Rq, float kd, const JrsTrig& c,
                                                float* out) {
  const float W = Rq + fabsf(kd);
  const float jlo = qc - W, jhi = qc + W;
  const float w2 = W * W;
  const float sq = sinf(qc), cq = cosf(qc);
  float lo1, hi1, lo2, hi2, mlo, mhi;

  // cos over J: 1 / -1 where J holds a multiple of 2 pi / pi
  const float clo = cosf(jlo), chi = cosf(jhi);
  const float cmax = jrs_contains(jlo, jhi, c.two_pi, 0.0f) ? 1.0f : jrs_max(clo, chi);
  const float cmin = jrs_contains(jlo, jhi, c.two_pi, c.pi) ? -1.0f : jrs_min(clo, chi);
  jrs_scale(-Rq, Rq, -sq, &lo1, &hi1);
  jrs_mul_pow(cmin, cmax, w2, &mlo, &mhi);
  jrs_scale(mlo, mhi, -0.5f, &lo2, &hi2);
  float lo = lo1 + lo2, hi = hi1 + hi2;
  out[0] = cq + (lo + hi) * 0.5f;
  out[1] = (-kd) * sq;
  out[2] = (hi - lo) * 0.5f;

  const float slo = sinf(jlo), shi = sinf(jhi);
  const float smax = jrs_contains(jlo, jhi, c.two_pi, c.half_pi) ? 1.0f : jrs_max(slo, shi);
  const float smin = jrs_contains(jlo, jhi, c.two_pi, c.neg_half_pi) ? -1.0f : jrs_min(slo, shi);
  jrs_scale(-Rq, Rq, cq, &lo1, &hi1);
  jrs_mul_pow(smin, smax, w2, &mlo, &mhi);
  jrs_scale(mlo, mhi, -0.5f, &lo2, &hi2);
  lo = lo1 + lo2;
  hi = hi1 + hi2;
  out[3] = sq + (lo + hi) * 0.5f;
  out[4] = kd * cq;
  out[5] = (hi - lo) * 0.5f;
}

// jrs.py:_rot_pattern: the axis rotation's (cos, sin) entries, zeros elsewhere
__device__ __forceinline__ void jrs_pattern(int axis, float c, float s, float* P) {
  for (int i = 0; i < 9; ++i) P[i] = 0.0f;
  if (axis == 1) {
    P[4] = c; P[5] = -s; P[7] = s; P[8] = c;
  } else if (axis == 2) {
    P[0] = c; P[2] = s; P[6] = -s; P[8] = c;
  } else {
    P[0] = c; P[1] = -s; P[3] = s; P[4] = c;
  }
}

// rotm @ P, each entry summed in the order b = 0, 1, 2
__device__ __forceinline__ void jrs_rotate(const float* rotm, const float* P, float* out) {
  for (int r = 0; r < 3; ++r)
    for (int col = 0; col < 3; ++col)
      out[r * 3 + col] = (rotm[r * 3 + 0] * P[0 * 3 + col] + rotm[r * 3 + 1] * P[1 * 3 + col])
                         + rotm[r * 3 + 2] * P[2 * 3 + col];
}

// A joint's four 3x3 matrices m[4][9] (centre, k coefficient, cos error,
// sin error) from its trig data; axis is signed (a reversed joint rotates
// by -q), 0 a fixed joint (centre = rotm, the rest 0).
__device__ __forceinline__ void jrs_joint_mats(int axis, const float* rotm, const float* trig,
                                               float m[4][9]) {
  if (axis == 0 || trig == nullptr) {
    for (int i = 0; i < 9; ++i) {
      m[0][i] = rotm[i];
      m[1][i] = 0.0f;
      m[2][i] = 0.0f;
      m[3][i] = 0.0f;
    }
    return;
  }
  const float sign = axis > 0 ? 1.0f : -1.0f;
  const int ax = axis > 0 ? axis : -axis;
  float P[9];
  jrs_pattern(ax, trig[0], sign * trig[3], P);
  P[(ax - 1) * 4] = P[(ax - 1) * 4] + 1.0f;      // + the axis' unit diagonal
  jrs_rotate(rotm, P, m[0]);
  jrs_pattern(ax, trig[1], sign * trig[4], P);
  jrs_rotate(rotm, P, m[1]);
  jrs_pattern(ax, trig[2], 0.0f, P);
  jrs_rotate(rotm, P, m[2]);
  jrs_pattern(ax, 0.0f, trig[5], P);
  jrs_rotate(rotm, P, m[3]);
}

// Where a block writes one (world, time) slab wt of a JRS.
struct JrsOut {
  float* R_coef;       // [W*T, J+1, 3, 3, B]
  float* R_egen;       // [W*T, J+1, 3, 3, E]
  float* R_rad;        // [W*T, J+1, 3, 3]
  float* v_coef;       // [3, W*T, F, B]: qd, qda, qdda
  float* v_egen;       // [3, W*T, F, E]
  float* v_rad;        // [3, W*T, F]
  long long WT;        // W * T
  int J, F, B, E;
  int e_cos, e_sin;    // error-generator columns of joint 0's cos / sin error
  int e_vel[3];        // error-generator columns of factor 0's qde / qdae / qddae
};

// The block writes slab wt from rot[j][4][9] (jrs_joint_mats of every joint,
// the identity last) and vel[p][3][f] (p = qd, qda, qdda: centre, k
// coefficient, error radius), lin[f] the basis column of k_f.  Every entry
// is written (zeros included), a warp per row, lanes along the row.
__device__ __forceinline__ void jrs_write_slab(const JrsOut& o, long long wt, const int* lin,
                                               float (*rot)[4][9], float (*vel)[3][JRS_MAXF]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int J1 = o.J + 1, B = o.B, E = o.E, F = o.F;
  float* Rc = o.R_coef + wt * J1 * 9 * B;
  float* Re = o.R_egen + wt * J1 * 9 * E;
  for (int r = warp; r < J1 * 9; r += nwarps) {
    const int j = r / 9, e = r - (r / 9) * 9;
    const float c0 = rot[j][0][e], ck = rot[j][1][e], ce = rot[j][2][e], se = rot[j][3][e];
    const int lj = j < F ? lin[j] : -1;
    const int jc = j < F ? o.e_cos + j : -1, js = j < F ? o.e_sin + j : -1;
    float* row = Rc + (long long)r * B;
    for (int b = lane; b < B; b += 32) row[b] = b == 0 ? c0 : (b == lj ? ck : 0.0f);
    row = Re + (long long)r * E;
    for (int x = lane; x < E; x += 32) row[x] = x == jc ? ce : (x == js ? se : 0.0f);
  }
  for (int i = threadIdx.x; i < J1 * 9; i += blockDim.x) o.R_rad[wt * J1 * 9 + i] = 0.0f;
  for (int r = warp; r < 3 * F; r += nwarps) {
    const int p = r / F, f = r - (r / F) * F;
    const long long slab = (p * o.WT + wt) * F + f;
    const float c0 = vel[p][0][f], ck = vel[p][1][f], ce = vel[p][2][f];
    const int lf = lin[f], ef = o.e_vel[p] + f;
    float* row = o.v_coef + slab * B;
    for (int b = lane; b < B; b += 32) row[b] = b == 0 ? c0 : (b == lf ? ck : 0.0f);
    row = o.v_egen + slab * E;
    for (int x = lane; x < E; x += 32) row[x] = x == ef ? ce : 0.0f;
    if (lane == 0) o.v_rad[slab] = 0.0f;
  }
}
