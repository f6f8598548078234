// The smooth mode's rule for the screened collision rows (the branch of
// armour_tpu/collision.py:277-290 that cfg.smooth_obstacle_constraints turns
// on), shared by K4 (collision_rows.cu) and K7 / K8 (alm_rows.cuh), so that
// one copy decides its rounding.  For screened row r at G link centres
// (p0, p1, p2)[g], over the 2C candidates x (pos[0..C-1], then neg; -BIG for
// a degenerate normal), in the plain version's order:
//
//   the max mx first, then the exponentials against it (the second pass
//   reads the row's 5C floats again, from L1 / L2):
//   m[g] = mx + tau logf(sum_c expf((x_c - mx) / tau)) - tau_log2c,
//   and, when gp0 is given, dm/dp negated: -(sum_pos w A - sum_neg w A) / Z,
//   the softmax blend of the signed normals, in gp0 / gp1 / gp2.
//
// tau_log2c is tau log(2C) as the plain version rounds it
// (collision.py:smooth_shift).  A link centre that is not finite gives NaN
// (the exponentials of NaN), as the plain version's amax does.  Built
// without fast math and with -fmad=false: expf / logf / the division by tau
// are the accurate library versions.
#pragma once
#include <cuda_runtime.h>

#define COLLISION_RULE_BIG 1e8f

// A [3, C, K], d / delta [C, K]: the row's world, row r along the last axis
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
