// K5: one tracking move of the closed loop (controller + true plant, RK4),
// every control step of the move inside one launch.
//
// Replaces the lax.scan of armour_tpu/simulator.py:111-164 (make_rollout,
// integrate mode) with its per-step controller (controller.py:61-95
// robust_control, :98-105 nominal_passivity_control, :121-153
// althoff_control) and plant (rnea_numeric.py:79-190 rnea, mass_matrix,
// coriolis_gravity); native/armour_rt.cpp:208-426 is the host twin.
//
// Per world and control step i (reference q_des/qd_des/qdd_des at time
// i * dt, precomputed by trajectory.desired_state for the whole move):
//   controller on the measured state (state + optional noise):
//     tau = RNEA(q, qd, qd_ref, qdd_ref; nominal), mr = RNEA(q, 0, 0, r),
//     2J perturbation chains at (qd, qd_ref, qdd_ref) and 2J at (0, 0, r);
//     u = tau + lambda r (robust), tau (nominal), tau + (kappa |bound| +
//     phi) r (althoff, E(t) carried per world);
//   plant: M(q) from F unit-acceleration RNEA columns with the true
//     inertials, inverted once per control step (Gauss-Jordan, partial
//     pivoting); `substeps` RK4 substeps of qdd = M^-1 (u - bias(q, qd)),
//     the bias re-evaluated at each of the 4 stages;
//   log row i: the state after the step and u.
//
// Bound on the H100 (flagship, W = 64, n = 500, F = J = 7; chip_smoke.py
// k5_work counts it): the move reads and writes ~0.6 MB (references and
// logs), ~0.2 us at 3.35 TB/s; the function needs ~45 kFLOP per
// world-step (45 RNEA passes, with the joint rotations, the kinematic
// recursions and the sparse perturbation passes counted once each),
// ~22 MFLOP per world-move, ~1.4 GFLOP per move, ~0.02 ms at 67 TFLOP/s.
// That bound is not reachable: the move is a chain of n
// steps, each a chain of 1 (parallel controller and mass-matrix passes) +
// 4 * substeps (bias passes) dependent RNEA evaluations; ~1,200 dependent
// float32 operations per step at ~4 cycles each make a serial chain of
// ~1.2 ms per move at the card's 1.98 GHz maximum clock.
//
// Design, simple first: one warp (one block) per world.  The 2 + 4J + F
// independent RNEA chains of a step (37 for the Kinova) are spread over the
// 32 lanes, each chain a register-resident 7-joint pass; lane 0 then reduces
// rho, V_sup and lambda, forms M^-1 and runs the 8 dependent bias passes of
// the 2 RK4 substeps, and writes the step's log row.  64 warps leave most
// of the card idle.  Built with -fmad=false and no fast math, so that each
// RNEA pass repeats the plain version's float32 operations.
#include <cuda_runtime.h>

#define K5_MAXJ 8
#define K5_MAXC (2 + 4 * K5_MAXJ + K5_MAXJ)

struct K5Robot {
  int J, F;
  int axes[K5_MAXJ];                 // 1/2/3 = x/y/z, negative = flipped, 0 = fixed
  float trans[(K5_MAXJ + 1) * 3];
  float rot[K5_MAXJ * 9];            // fixed rpy rotation per joint, row-major
  float mass[K5_MAXJ];               // nominal inertials
  float com[K5_MAXJ * 3];
  float inertia[K5_MAXJ * 9];
  float armature[K5_MAXJ];
  float damping[K5_MAXJ];
  float gravity;
  float mass_unc, inertia_unc;
};

struct K5Args {
  K5Robot rb;
  const float* q0;          // [W, F]
  const float* qd0;         // [W, F]
  const float* q_des;       // [W, n, F]
  const float* qd_des;      // [W, n, F]
  const float* qdd_des;     // [W, n, F]
  const float* noise;       // [W, n, 2, F] or null
  const float* tmass;       // [W, J] true inertials
  const float* tinertia;    // [W, J, 3, 3]
  const float* tcom;        // [W, J, 3]
  float* q_out;             // [W, F]
  float* qd_out;            // [W, F]
  float* q_log;             // [W, n, F]
  float* qd_log;            // [W, n, F]
  float* u_log;             // [W, n, F]
  float k_r, alpha, v_max, dt, h, half_h, h6;
  float kp0, kp1, ki0, ki1, max_error;
  int W, n, substeps, controller;   // controller: 0 robust, 1 nominal, 2 althoff
};

enum { K5_NOMINAL = 0, K5_TRUE = 1, K5_MASS_DIR = 2, K5_INERTIA_DIR = 3 };

struct K5True {                      // one world's true inertials (shared memory)
  float mass[K5_MAXJ];
  float com[K5_MAXJ * 3];
  float inertia[K5_MAXJ * 9];
};

__device__ __forceinline__ void k5_cross(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// o = M v (M row-major 3x3)
__device__ __forceinline__ void k5_mv(const float* M, const float v[3], float o[3]) {
  for (int a = 0; a < 3; ++a) o[a] = M[3 * a] * v[0] + M[3 * a + 1] * v[1] + M[3 * a + 2] * v[2];
}

// o = M^T v
__device__ __forceinline__ void k5_mtv(const float* M, const float v[3], float o[3]) {
  for (int a = 0; a < 3; ++a) o[a] = M[a] * v[0] + M[3 + a] * v[1] + M[6 + a] * v[2];
}

// R_i = rot_i @ Rot_axis(sgn * q_i) for every joint
__device__ void k5_rotations(const K5Robot& rb, const float* q, float Rs[K5_MAXJ][9]) {
#pragma unroll
  for (int i = 0; i < K5_MAXJ; ++i) {
    if (i >= rb.J) break;
    const int axis = rb.axes[i];
    float Ra[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    if (axis != 0 && i < rb.F) {
      const float th = (axis > 0 ? 1.0f : -1.0f) * q[i];
      const float c = cosf(th), s = sinf(th);
      const int a = (axis > 0 ? axis : -axis) - 1;
      if (a == 0) {
        Ra[4] = c; Ra[5] = -s; Ra[7] = s; Ra[8] = c;
      } else if (a == 1) {
        Ra[0] = c; Ra[2] = s; Ra[6] = -s; Ra[8] = c;
      } else {
        Ra[0] = c; Ra[1] = -s; Ra[3] = s; Ra[4] = c;
      }
    }
    const float* P = rb.rot + 9 * i;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        Rs[i][3 * a + b] = P[3 * a] * Ra[b] + P[3 * a + 1] * Ra[3 + b] + P[3 * a + 2] * Ra[6 + b];
  }
}

// link i's inertials as chain `kind` sees them (link = the perturbed link)
__device__ __forceinline__ void k5_link(const K5Robot& rb, const K5True& tr, int kind, int link,
                                        int i, float& m, float c[3], float I[9]) {
  const float* cp = (kind == K5_TRUE) ? tr.com + 3 * i : rb.com + 3 * i;
  c[0] = cp[0]; c[1] = cp[1]; c[2] = cp[2];
  if (kind == K5_NOMINAL || kind == K5_TRUE) {
    const float* Ip = (kind == K5_TRUE) ? tr.inertia + 9 * i : rb.inertia + 9 * i;
    m = (kind == K5_TRUE) ? tr.mass[i] : rb.mass[i];
    for (int k = 0; k < 9; ++k) I[k] = Ip[k];
  } else if (kind == K5_MASS_DIR) {
    m = (i == link) ? rb.mass[i] * rb.mass_unc : 0.0f;
    for (int k = 0; k < 9; ++k) I[k] = 0.0f;
  } else {
    m = 0.0f;
    for (int k = 0; k < 9; ++k) I[k] = (i == link) ? rb.inertia[9 * i + k] * rb.inertia_unc : 0.0f;
  }
}

// passivity-form RNEA (rnea_numeric.py:79-168), one chain, tau[F]
__device__ void k5_rnea(const K5Robot& rb, const K5True& tr, const float Rs[K5_MAXJ][9],
                        const float* qd, const float* qa, const float* qdd, int kind, int link,
                        bool grav, bool arm, float* tau) {
  float w[3] = {0.f, 0.f, 0.f}, wa[3] = {0.f, 0.f, 0.f}, wd[3] = {0.f, 0.f, 0.f};
  float acc[3] = {0.f, 0.f, grav ? rb.gravity : 0.f};
  float Fv[K5_MAXJ][3], Nv[K5_MAXJ][3];
  const int J = rb.J;
#pragma unroll
  for (int i = 0; i < K5_MAXJ; ++i) {
    if (i >= J) break;
    const float* tri = rb.trans + 3 * i;
    float t0[3], t1[3], t2[3], s[3];
    k5_cross(wd, tri, t0);
    k5_cross(wa, tri, t1);
    k5_cross(w, t1, t2);
    for (int a = 0; a < 3; ++a) s[a] = acc[a] + t0[a] + t2[a];
    k5_mtv(Rs[i], s, acc);
    float tmp[3];
    k5_mtv(Rs[i], w, tmp); w[0] = tmp[0]; w[1] = tmp[1]; w[2] = tmp[2];
    k5_mtv(Rs[i], wa, tmp); wa[0] = tmp[0]; wa[1] = tmp[1]; wa[2] = tmp[2];
    k5_mtv(Rs[i], wd, tmp); wd[0] = tmp[0]; wd[1] = tmp[1]; wd[2] = tmp[2];
    const int axis = rb.axes[i];
    if (axis != 0 && i < rb.F) {
      const int ax = (axis > 0 ? axis : -axis) - 1;
      const float sg = axis > 0 ? 1.0f : -1.0f;
      float e[3] = {0.f, 0.f, 0.f};
      e[ax] = sg;
      float eq[3], eqdd[3], c1[3];
      for (int a = 0; a < 3; ++a) {
        eq[a] = e[a] * qd[i];
        eqdd[a] = e[a] * qdd[i];
      }
      for (int a = 0; a < 3; ++a) w[a] = w[a] + eq[a];
      k5_cross(wa, eq, c1);
      for (int a = 0; a < 3; ++a) wd[a] = wd[a] + c1[a] + eqdd[a];
      for (int a = 0; a < 3; ++a) wa[a] = wa[a] + e[a] * qa[i];
    }
    float m, cb[3], Ib[9];
    k5_link(rb, tr, kind, link, i, m, cb, Ib);
    float c0[3], c2[3], c3[3];
    k5_cross(wd, cb, c0);
    k5_cross(wa, cb, c2);
    k5_cross(w, c2, c3);
    for (int a = 0; a < 3; ++a) Fv[i][a] = m * (acc[a] + c0[a] + c3[a]);
    float Iw[3], Iwd[3], c4[3];
    k5_mv(Ib, wd, Iwd);
    k5_mv(Ib, w, Iw);
    k5_cross(wa, Iw, c4);
    for (int a = 0; a < 3; ++a) Nv[i][a] = Iwd[a] + c4[a];
  }
  float f[3] = {0.f, 0.f, 0.f}, n[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = K5_MAXJ - 1; i >= 0; --i) {
    if (i >= J) continue;
    float rf[3], rn[3];
    if (i + 1 < J) {
      k5_mv(Rs[i + 1], f, rf);
      k5_mv(Rs[i + 1], n, rn);
    } else {
      for (int a = 0; a < 3; ++a) { rf[a] = f[a]; rn[a] = n[a]; }
    }
    float cb[3];
    const float* cp = (kind == K5_TRUE) ? tr.com + 3 * i : rb.com + 3 * i;
    cb[0] = cp[0]; cb[1] = cp[1]; cb[2] = cp[2];
    float c0[3], c1[3];
    k5_cross(cb, Fv[i], c0);
    k5_cross(rb.trans + 3 * (i + 1), rf, c1);
    for (int a = 0; a < 3; ++a) {
      n[a] = Nv[i][a] + rn[a] + c0[a] + c1[a];
      f[a] = rf[a] + Fv[i][a];
    }
    const int axis = rb.axes[i];
    if (axis != 0 && i < rb.F) {
      const int ax = (axis > 0 ? axis : -axis) - 1;
      float t = (axis > 0 ? 1.0f : -1.0f) * n[ax];
      if (arm) t = t + rb.armature[i] * qdd[i];
      if (rb.damping[i] != 0.0f) t = t + rb.damping[i] * qd[i];
      tau[i] = t;
    }
  }
}

// bias(q, qd) with the true inertials, then qdd = M^-1 (u - bias)
__device__ void k5_accel(const K5Robot& rb, const K5True& tr, const float Minv[K5_MAXJ][K5_MAXJ],
                         const float* q, const float* qd, const float* u, float* qdd) {
  float Rs[K5_MAXJ][9];
  k5_rotations(rb, q, Rs);
  const float zero[K5_MAXJ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float bias[K5_MAXJ], rhs[K5_MAXJ];
  k5_rnea(rb, tr, Rs, qd, qd, zero, K5_TRUE, -1, true, false, bias);
  const int F = rb.F;
  for (int j = 0; j < F; ++j) rhs[j] = u[j] - bias[j];
  for (int i = 0; i < F; ++i) {
    float s = 0.0f;
    for (int j = 0; j < F; ++j) s = s + Minv[i][j] * rhs[j];
    qdd[i] = s;
  }
}

__global__ void __launch_bounds__(32) k5_kernel(const K5Args args) {
  const K5Robot& rb = args.rb;
  const int w = blockIdx.x;
  const int lane = threadIdx.x;
  const int J = rb.J, F = rb.F, n = args.n;
  const int n_chains = 2 + 4 * J + F;

  __shared__ K5True tr;
  __shared__ float sq[K5_MAXJ], sqd[K5_MAXJ];
  __shared__ float stau[K5_MAXC][K5_MAXJ];

  for (int k = lane; k < J; k += 32) tr.mass[k] = args.tmass[w * J + k];
  for (int k = lane; k < 3 * J; k += 32) tr.com[k] = args.tcom[w * 3 * J + k];
  for (int k = lane; k < 9 * J; k += 32) tr.inertia[k] = args.tinertia[w * 9 * J + k];
  for (int k = lane; k < F; k += 32) {
    sq[k] = args.q0[w * F + k];
    sqd[k] = args.qd0[w * F + k];
  }
  float e_acc = 0.0f;          // althoff E(t), lane 0
  __syncwarp();

  for (int s = 0; s < n; ++s) {
    const long long row = ((long long)w * n + s) * F;
    // measured state and the controller's references (every lane)
    float qm[K5_MAXJ], qdm[K5_MAXJ], qt[K5_MAXJ], err[K5_MAXJ], derr[K5_MAXJ];
    float qd_ref[K5_MAXJ], qdd_ref[K5_MAXJ], r[K5_MAXJ];
    for (int f = 0; f < F; ++f) {
      qt[f] = sq[f];
      qm[f] = sq[f];
      qdm[f] = sqd[f];
      if (args.noise != nullptr) {
        const long long nb = (((long long)w * n + s) * 2) * F;
        qm[f] = sq[f] + args.noise[nb + f];
        qdm[f] = sqd[f] + args.noise[nb + F + f];
      }
      err[f] = args.q_des[row + f] - qm[f];
      derr[f] = args.qd_des[row + f] - qdm[f];
      qd_ref[f] = args.qd_des[row + f] + args.k_r * err[f];
      qdd_ref[f] = args.qdd_des[row + f] + args.k_r * derr[f];
      r[f] = derr[f] + args.k_r * err[f];
    }
    const float zero[K5_MAXJ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

    // the step's independent RNEA chains, spread over the lanes
    float Rm[K5_MAXJ][9];
    k5_rotations(rb, qm, Rm);
    for (int c = lane; c < n_chains; c += 32) {
      float tau[K5_MAXJ];
      if (c == 0) {
        k5_rnea(rb, tr, Rm, qdm, qd_ref, qdd_ref, K5_NOMINAL, -1, true, true, tau);
      } else if (c == 1) {
        k5_rnea(rb, tr, Rm, zero, zero, r, K5_NOMINAL, -1, false, true, tau);
      } else if (c < 2 + 4 * J) {
        const int p = (c - 2) % (2 * J);
        const int kind = p < J ? K5_MASS_DIR : K5_INERTIA_DIR;
        const int link = p < J ? p : p - J;
        if (c < 2 + 2 * J)
          k5_rnea(rb, tr, Rm, qdm, qd_ref, qdd_ref, kind, link, true, false, tau);
        else
          k5_rnea(rb, tr, Rm, zero, zero, r, kind, link, true, false, tau);
      } else {
        const int j = c - 2 - 4 * J;
        float Rt[K5_MAXJ][9];
        k5_rotations(rb, qt, Rt);
        float ej[K5_MAXJ] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        ej[j] = 1.0f;
        k5_rnea(rb, tr, Rt, zero, zero, ej, K5_TRUE, -1, false, true, tau);
      }
      for (int f = 0; f < F; ++f) stau[c][f] = tau[f];
    }
    __syncwarp();

    if (lane == 0) {
      // controller
      float u[K5_MAXJ];
      const float* tau = stau[0];
      if (args.controller == 1) {
        for (int f = 0; f < F; ++f) u[f] = tau[f];
      } else {
        float dist_sup[K5_MAXJ];
        for (int f = 0; f < F; ++f) {
          float a = 0.0f;
          for (int p = 0; p < 2 * J; ++p) a = a + fabsf(stau[2 + p][f]);
          dist_sup[f] = a;
        }
        if (args.controller == 0) {
          float rho = 0.0f, vn = 0.0f, r_sq = 0.0f, vp = 0.0f;
          for (int f = 0; f < F; ++f) rho = rho + fabsf(r[f]) * dist_sup[f];
          for (int f = 0; f < F; ++f) vn = vn + r[f] * stau[1][f];
          for (int p = 0; p < 2 * J; ++p) {
            float d = 0.0f;
            for (int f = 0; f < F; ++f) d = d + stau[2 + 2 * J + p][f] * r[f];
            vp = vp + fabsf(d);
          }
          for (int f = 0; f < F; ++f) r_sq = r_sq + r[f] * r[f];
          const float v_sup = 0.5f * vn + 0.5f * vp;
          const float hh = args.v_max - v_sup;
          const float lam = fmaxf((-args.alpha * hh + rho) / fmaxf(r_sq, 1e-12f), 0.0f);
          for (int f = 0; f < F; ++f) u[f] = tau[f] + (r_sq > 0.0f ? lam * r[f] : 0.0f);
        } else {
          float bn = 0.0f, es = 0.0f, ds = 0.0f;
          for (int f = 0; f < F; ++f) bn = bn + dist_sup[f] * dist_sup[f];
          bn = sqrtf(bn);
          for (int f = 0; f < F; ++f) es = es + err[f] * err[f];
          for (int f = 0; f < F; ++f) ds = ds + derr[f] * derr[f];
          const float state_err = sqrtf(es + ds);
          e_acc = e_acc + (state_err > args.max_error ? state_err * args.dt : 0.0f);
          const float phi = args.kp0 + args.ki0 * e_acc;
          const float kappa = args.kp1 + args.ki1 * e_acc;
          const float gain = kappa * bn + phi;
          for (int f = 0; f < F; ++f) u[f] = tau[f] + gain * r[f];
        }
      }

      // M(q) (true inertials) and its inverse: Gauss-Jordan, partial pivoting
      float A[K5_MAXJ][2 * K5_MAXJ];
      for (int i = 0; i < F; ++i)
        for (int j = 0; j < F; ++j) {
          A[i][j] = stau[2 + 4 * J + j][i];
          A[i][F + j] = (i == j) ? 1.0f : 0.0f;
        }
      for (int c = 0; c < F; ++c) {
        int p = c;
        for (int i = c + 1; i < F; ++i)
          if (fabsf(A[i][c]) > fabsf(A[p][c])) p = i;
        if (p != c)
          for (int k = 0; k < 2 * F; ++k) {
            const float t = A[c][k]; A[c][k] = A[p][k]; A[p][k] = t;
          }
        const float d = A[c][c];
        for (int k = 0; k < 2 * F; ++k) A[c][k] = A[c][k] / d;
        for (int i = 0; i < F; ++i) {
          if (i == c) continue;
          const float fac = A[i][c];
          for (int k = 0; k < 2 * F; ++k) A[i][k] = A[i][k] - fac * A[c][k];
        }
      }
      float Minv[K5_MAXJ][K5_MAXJ];
      for (int i = 0; i < F; ++i)
        for (int j = 0; j < F; ++j) Minv[i][j] = A[i][F + j];

      // RK4 substeps with M^-1 held
      float q[K5_MAXJ], qd[K5_MAXJ];
      for (int f = 0; f < F; ++f) { q[f] = sq[f]; qd[f] = sqd[f]; }
      for (int sub = 0; sub < args.substeps; ++sub) {
        float k1[K5_MAXJ], k2[K5_MAXJ], k3[K5_MAXJ], k4[K5_MAXJ];
        float v2[K5_MAXJ], v3[K5_MAXJ], v4[K5_MAXJ], tq[K5_MAXJ];
        k5_accel(rb, tr, Minv, q, qd, u, k1);
        for (int f = 0; f < F; ++f) {
          tq[f] = q[f] + args.half_h * qd[f];
          v2[f] = qd[f] + args.half_h * k1[f];
        }
        k5_accel(rb, tr, Minv, tq, v2, u, k2);
        for (int f = 0; f < F; ++f) {
          tq[f] = q[f] + args.half_h * v2[f];
          v3[f] = qd[f] + args.half_h * k2[f];
        }
        k5_accel(rb, tr, Minv, tq, v3, u, k3);
        for (int f = 0; f < F; ++f) {
          tq[f] = q[f] + args.h * v3[f];
          v4[f] = qd[f] + args.h * k3[f];
        }
        k5_accel(rb, tr, Minv, tq, v4, u, k4);
        for (int f = 0; f < F; ++f) {
          const float dq = qd[f] + 2.0f * v2[f] + 2.0f * v3[f] + v4[f];
          const float dv = k1[f] + 2.0f * k2[f] + 2.0f * k3[f] + k4[f];
          q[f] = q[f] + args.h6 * dq;
          qd[f] = qd[f] + args.h6 * dv;
        }
      }
      for (int f = 0; f < F; ++f) {
        sq[f] = q[f];
        sqd[f] = qd[f];
        args.q_log[row + f] = q[f];
        args.qd_log[row + f] = qd[f];
        args.u_log[row + f] = u[f];
      }
    }
    __syncwarp();
  }
  for (int k = lane; k < F; k += 32) {
    args.q_out[w * F + k] = sq[k];
    args.qd_out[w * F + k] = sqd[k];
  }
}

extern "C" int k5_launch(const K5Args* args, void* stream) {
  if (args->rb.J > K5_MAXJ || args->rb.F > args->rb.J) return (int)cudaErrorInvalidValue;
  k5_kernel<<<args->W, 32, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
