// The rules of the collision rows, shared by K4 (collision_rows.cu) and K7 /
// K8 (alm_rows.cuh), so that one copy decides their rounding.  For a row at
// G link centres (p0, p1, p2)[g], over the 2C candidates x (pos[0..C-1],
// then neg; -BIG for a degenerate normal), in the plain version's order:
//
// The hard rule (armour_tpu/collision.py:255-302): m[g] = max x, the FIRST
// maximal candidate (strict > in index order, pos before neg: a tie keeps
// the pos index), as jnp.argmax gives, and its normal's index and sign.
// With NAN_FIRST a NaN candidate (a link centre that is not finite) is the
// max and the first NaN the argmax, as in torch.amax / argmax; K7 / K8 keep
// their rule without it.  collision_hard_step takes one candidate pair, so
// that K4's cell mode can feed it the rows it forms (hyperplane_cell.cuh).
//
// The smooth mode's rule (the branch of armour_tpu/collision.py:277-290
// that cfg.smooth_obstacle_constraints turns on): the max mx first, then
// the exponentials against it (the second pass reads the row's 5C floats
// again, from L1 / L2):
//   m[g] = mx + tau logf(sum_c expf((x_c - mx) / tau)) - tau_log2c,
//   and, when gp0 is given, dm/dp negated: -(sum_pos w A - sum_neg w A) / Z,
//   the softmax blend of the signed normals, in gp0 / gp1 / gp2.
// tau_log2c is tau log(2C) as the plain version rounds it
// (collision.py:smooth_shift).  A link centre that is not finite gives NaN
// (the exponentials of NaN), as the plain version's amax does.
//
// Built without fast math and with -fmad=false: expf / logf / the division
// by tau are the accurate library versions, and the products are not
// contracted, so every G gives G = 1's bits for each of its link centres.
#pragma once
#include <cuda_runtime.h>

#define COLLISION_RULE_BIG 1e8f

// one candidate pair c (normal A, offset dd, buffer de) of the hard rule at
// G link centres: the running first maxima of the pos and neg sides
template <int G, bool NAN_FIRST>
__device__ __forceinline__ void collision_hard_step(int c, float A0, float A1, float A2,
                                                    float dd, float de, const float* p0,
                                                    const float* p1, const float* p2,
                                                    float* best_p, float* best_n, int* ip,
                                                    int* in) {
  const bool ok = fabsf(A0) + fabsf(A1) + fabsf(A2) > 0.0f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float Ap = A0 * p0[g] + A1 * p1[g] + A2 * p2[g];
    const float pos = ok ? Ap - (dd + de) : -COLLISION_RULE_BIG;
    const float neg = ok ? -Ap - (-dd + de) : -COLLISION_RULE_BIG;
    if (c == 0 || pos > best_p[g] || (NAN_FIRST && isnan(pos) && !isnan(best_p[g]))) {
      best_p[g] = pos;
      ip[g] = c;
    }
    if (c == 0 || neg > best_n[g] || (NAN_FIRST && isnan(neg) && !isnan(best_n[g]))) {
      best_n[g] = neg;
      in[g] = c;
    }
  }
}

// the hard rule's choice after the last pair: m[g] and, when comb is given,
// the chosen normal's index and sign
template <int G, bool NAN_FIRST>
__device__ __forceinline__ void collision_hard_pick(const float* best_p, const float* best_n,
                                                    const int* ip, const int* in, float* m,
                                                    int* comb, float* sign) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    // pos candidates precede neg ones: a tie keeps the pos index
    const bool use_neg = best_n[g] > best_p[g] || (NAN_FIRST && isnan(best_n[g]) &&
                                                   !isnan(best_p[g]));
    m[g] = use_neg ? best_n[g] : best_p[g];
    if (comb != nullptr) {
      comb[g] = use_neg ? in[g] : ip[g];
      sign[g] = use_neg ? 1.0f : -1.0f;
    }
  }
}

// the hard rule for row r of A [3, C, K], d / delta [C, K] (the row's world)
template <int G, bool NAN_FIRST>
__device__ __forceinline__ void collision_hard_rule(const float* Aw, const float* dw,
                                                    const float* delw, long long K, int C,
                                                    long long r, const float* p0,
                                                    const float* p1, const float* p2, float* m,
                                                    int* comb, float* sign) {
  float best_p[G], best_n[G];
  int ip[G], in[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    best_p[g] = 0.0f;
    best_n[g] = 0.0f;
    ip[g] = 0;
    in[g] = 0;
  }
#pragma unroll 4
  for (int cc = 0; cc < C; ++cc) {
    collision_hard_step<G, NAN_FIRST>(cc, Aw[(0 * C + cc) * K + r], Aw[(1 * C + cc) * K + r],
                                      Aw[(2 * C + cc) * K + r], dw[cc * K + r],
                                      delw[cc * K + r], p0, p1, p2, best_p, best_n, ip, in);
  }
  collision_hard_pick<G, NAN_FIRST>(best_p, best_n, ip, in, m, comb, sign);
}

// the smooth rule for row r of A [3, C, K], d / delta [C, K] (the row's world)
template <int G>
__device__ __forceinline__ void collision_smooth_rule(const float* Aw, const float* dw,
                                                      const float* delw, long long K, int C,
                                                      long long r, float tau, float tau_log2c,
                                                      const float* p0, const float* p1,
                                                      const float* p2, float* m, float* gp0,
                                                      float* gp1, float* gp2) {
  float mx[G], Z[G], s0[G], s1[G], s2[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    mx[g] = 0.0f;
    Z[g] = 0.0f;
    s0[g] = 0.0f;
    s1[g] = 0.0f;
    s2[g] = 0.0f;
  }
#pragma unroll 4
  for (int cc = 0; cc < C; ++cc) {
    const float A0 = Aw[(0 * C + cc) * K + r];
    const float A1 = Aw[(1 * C + cc) * K + r];
    const float A2 = Aw[(2 * C + cc) * K + r];
    const bool ok = fabsf(A0) + fabsf(A1) + fabsf(A2) > 0.0f;
    const float dd = dw[cc * K + r], de = delw[cc * K + r];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float Ap = A0 * p0[g] + A1 * p1[g] + A2 * p2[g];
      const float pos = ok ? Ap - (dd + de) : -COLLISION_RULE_BIG;
      const float neg = ok ? -Ap - (-dd + de) : -COLLISION_RULE_BIG;
      if (cc == 0 || pos > mx[g]) mx[g] = pos;
      if (neg > mx[g]) mx[g] = neg;
    }
  }
#pragma unroll 2
  for (int cc = 0; cc < C; ++cc) {
    const float A0 = Aw[(0 * C + cc) * K + r];
    const float A1 = Aw[(1 * C + cc) * K + r];
    const float A2 = Aw[(2 * C + cc) * K + r];
    const bool ok = fabsf(A0) + fabsf(A1) + fabsf(A2) > 0.0f;
    const float dd = dw[cc * K + r], de = delw[cc * K + r];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float Ap = A0 * p0[g] + A1 * p1[g] + A2 * p2[g];
      const float wp = expf(((ok ? Ap - (dd + de) : -COLLISION_RULE_BIG) - mx[g]) / tau);
      const float wn = expf(((ok ? -Ap - (-dd + de) : -COLLISION_RULE_BIG) - mx[g]) / tau);
      Z[g] += wp + wn;
      if (gp0 != nullptr) {
        s0[g] += A0 * wp - A0 * wn;
        s1[g] += A1 * wp - A1 * wn;
        s2[g] += A2 * wp - A2 * wn;
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = mx[g] + tau * logf(Z[g]) - tau_log2c;
    if (gp0 != nullptr) {
      gp0[g] = -(s0[g] / Z[g]);
      gp1[g] = -(s1[g] / Z[g]);
      gp2[g] = -(s2[g] / Z[g]);
    }
  }
}
