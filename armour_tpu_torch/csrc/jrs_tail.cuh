// The per-element tail of an online joint reachable set, shared by the JRS
// kernels: the first-order Taylor of cos / sin with an interval Lagrange
// remainder (jrs.py:trig_taylor_pz, pz/interval.py), a joint's four
// rotation matrices (jrs.py:assemble_rotations: centre, k coefficient and
// the cos / sin error generators), and a block's write of its (world, time)
// slabs of R and of the three velocity PZs (jrs.py:make_velocity_pz) in the
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

// Where the blocks write the (world, time) slabs of a JRS.
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

// A family's arguments (K11Args, K12Args) name the outputs alike.
template <class Args>
__device__ __forceinline__ JrsOut jrs_out(const Args& a) {
  JrsOut o;
  o.R_coef = a.R_coef;
  o.R_egen = a.R_egen;
  o.R_rad = a.R_rad;
  o.v_coef = a.v_coef;
  o.v_egen = a.v_egen;
  o.v_rad = a.v_rad;
  o.WT = (long long)a.W * a.T;
  o.J = a.J;
  o.F = a.F;
  o.B = a.B;
  o.E = a.E;
  o.e_cos = a.e_cos;
  o.e_sin = a.e_sin;
  o.e_vel[0] = a.e_qde;
  o.e_vel[1] = a.e_qdae;
  o.e_vel[2] = a.e_qddae;
  return o;
}

// The writer (what bounds a JRS kernel on the H100: ~484 MB written at the
// flagship size, almost all of it the zeros of the dense PZ layout).  A
// block forms G <= JRS_MAX_G consecutive slabs at once, a thread per
// (slab, joint), into JrsSlabs; then, since each output tensor's range of
// those slabs is contiguous (R's [W T, J+1, 3, 3, .]; the velocity PZs'
// [3, W T, F, .], one range per p), it writes each range flat: every
// thread 16-byte streaming stores (__stcs on float4, evict-first: nothing
// reads them back before K9 / K10), neighbouring threads on neighbouring
// addresses, from the range's first 16-byte boundary, single floats before
// it and after its last whole float4 (ranges of F E = 266 floats start
// unaligned).  Each entry is computed from its flat index: zero but the
// centre column, the k column (lin) and the error columns, with the values
// the element stage left in shared memory, so the tensors hold the same
// bits as written row by row.  kernels/jrs.py:jrs_geometry picks G and the
// grid (every block resident at once at the flagship size: one pass of
// forming, then the stores; a grid-stride loop beyond).
// tests/test_torch_kernel_geometry.py repeats jrs_write_slabs' index
// arithmetic in Python for the CPU tests.
#define JRS_MAX_G 16        // slabs a block holds
#define JRS_R_COEF 0        // segment kinds
#define JRS_R_EGEN 1
#define JRS_V_COEF 2
#define JRS_V_EGEN 3
#define JRS_ZERO 4

// A block's slabs: rot[g][j] joint j's four matrices (centre, k
// coefficient, cos error, sin error; jrs_joint_mats, the identity last),
// vel[g][p][x][f] factor f's velocity PZ p (qd, qda, qdda) as (centre, k
// coefficient, error radius).
struct JrsSlabs {
  float rot[JRS_MAX_G][JRS_MAXJ][4][9];
  float vel[JRS_MAX_G][3][3][JRS_MAXF];
  int lin[JRS_MAXF];      // the basis column of k_f, read by lanes of differing rows
};

// Entry c of row r of slab g of a segment of KIND (velocity PZ p)
template <int KIND>
__device__ __forceinline__ float jrs_value(const JrsOut& o, const JrsSlabs& s, int p, int g, int r,
                                           int c) {
  const int* lin = s.lin;
  if (KIND == JRS_R_COEF) {
    const int j = r / 9, e = r - 9 * j;
    return c == 0 ? s.rot[g][j][0][e] : (j < o.F && c == lin[j]) ? s.rot[g][j][1][e] : 0.0f;
  }
  if (KIND == JRS_R_EGEN) {
    const int j = r / 9, e = r - 9 * j;
    if (j >= o.F) return 0.0f;
    return c == o.e_cos + j ? s.rot[g][j][2][e] : c == o.e_sin + j ? s.rot[g][j][3][e] : 0.0f;
  }
  if (KIND == JRS_V_COEF)
    return c == 0 ? s.vel[g][p][0][r] : c == lin[r] ? s.vel[g][p][1][r] : 0.0f;
  if (KIND == JRS_V_EGEN) return c == o.e_vel[p] + r ? s.vel[g][p][2][r] : 0.0f;
  return 0.0f;
}

// Flat entry x of a segment: slabs of slab_len entries, rows of L
template <int KIND>
__device__ __forceinline__ float jrs_entry(const JrsOut& o, const JrsSlabs& s, int p, int x,
                                           int slab_len, int L) {
  if (KIND == JRS_ZERO) return 0.0f;
  const int g = x / slab_len, y = x - g * slab_len, r = y / L;
  return jrs_value<KIND>(o, s, p, g, r, y - r * L);
}

// The columns [lo, hi] of a row of KIND that can hold a non-zero entry
// (the centre column 0 and the k columns lin; the error columns)
template <int KIND>
__device__ __forceinline__ void jrs_window(const JrsOut& o, const int* lin, int p, int* lo,
                                           int* hi) {
  int top = 0;
  for (int f = 0; f < o.F; ++f) top = max(top, lin[f]);
  if (KIND == JRS_R_COEF || KIND == JRS_V_COEF) {
    *lo = 0;
    *hi = top;
  } else if (KIND == JRS_R_EGEN) {
    *lo = min(o.e_cos, o.e_sin);
    *hi = max(o.e_cos, o.e_sin) + o.F - 1;
  } else {
    *lo = o.e_vel[p];
    *hi = o.e_vel[p] + o.F - 1;
  }
}

// Entries [0, len) of the segment at dst, by the whole block.  A thread
// finds its first float4's (slab, row, column) by division, then steps it
// by the block's stride (4 blockDim.x entries) with carries; a float4 whose
// four columns lie in one row outside the row's window (jrs_window) is
// zero without a look-up.
template <int KIND>
__device__ __forceinline__ void jrs_write_segment(float* dst, int len, int slab_len, int L, int p,
                                                  const JrsOut& o, const JrsSlabs& s) {
  const int head = min(len, (int)(((16u - ((unsigned)(size_t)dst & 15u)) & 15u) >> 2));
  const int n4 = (len - head) >> 2;
  for (int x = threadIdx.x; x < head; x += blockDim.x)
    __stcs(dst + x, jrs_entry<KIND>(o, s, p, x, slab_len, L));
  float4* d4 = (float4*)(dst + head);
  if (KIND == JRS_ZERO) {
    for (int i = threadIdx.x; i < n4; i += blockDim.x)
      __stcs(d4 + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
  } else if ((int)threadIdx.x < n4) {
    const int rows = slab_len / L, stride = 4 * blockDim.x;
    const int dq = stride / L, dc = stride - dq * L, dg = dq / rows, dr = dq - dg * rows;
    int lo, hi;
    jrs_window<KIND>(o, s.lin, p, &lo, &hi);
    const int x = head + 4 * threadIdx.x;
    int g = x / slab_len, y = x - g * slab_len, r = y / L, c = y - r * L;
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (!((c > hi || c + 3 < lo) && c + 3 < L)) {
        int gg = g, rr = r, cc = c;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          v[u] = jrs_value<KIND>(o, s, p, gg, rr, cc);
          if (++cc == L) {
            cc = 0;
            if (++rr == rows) {
              rr = 0;
              ++gg;
            }
          }
        }
      }
      __stcs(d4 + i, make_float4(v[0], v[1], v[2], v[3]));
      c += dc;
      if (c >= L) {
        c -= L;
        ++r;
      }
      r += dr;
      if (r >= rows) {
        r -= rows;
        ++g;
      }
      g += dg;
    }
  }
  for (int x = head + 4 * n4 + threadIdx.x; x < len; x += blockDim.x)
    __stcs(dst + x, jrs_entry<KIND>(o, s, p, x, slab_len, L));
}

// The block's n slabs wt0 .. wt0 + n - 1 of every output, from s.
__device__ __forceinline__ void jrs_write_slabs(const JrsOut& o, long long wt0, int n,
                                                const JrsSlabs& s) {
  const int J9 = (o.J + 1) * 9, B = o.B, E = o.E, F = o.F;
  jrs_write_segment<JRS_R_COEF>(o.R_coef + wt0 * J9 * B, n * J9 * B, J9 * B, B, 0, o, s);
  jrs_write_segment<JRS_R_EGEN>(o.R_egen + wt0 * J9 * E, n * J9 * E, J9 * E, E, 0, o, s);
  jrs_write_segment<JRS_ZERO>(o.R_rad + wt0 * J9, n * J9, J9, 1, 0, o, s);
  for (int p = 0; p < 3; ++p) {
    const long long slab = p * o.WT + wt0;
    jrs_write_segment<JRS_V_COEF>(o.v_coef + slab * F * B, n * F * B, F * B, B, p, o, s);
    jrs_write_segment<JRS_V_EGEN>(o.v_egen + slab * F * E, n * F * E, F * E, E, p, o, s);
    jrs_write_segment<JRS_ZERO>(o.v_rad + slab * F, n * F, F, 1, p, o, s);
  }
}
