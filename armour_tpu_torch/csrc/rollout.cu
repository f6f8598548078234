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
// ~22 MFLOP per world-move, ~1.4 GFLOP per move, 0.021 ms at 67 TFLOP/s.
// That bound is not reachable: the move is a chain of n steps, each a
// chain of 1 (parallel controller and mass-matrix passes) + 4 * substeps
// (bias passes) dependent RNEA evaluations; ~1,200 dependent float32
// operations per step at ~4 cycles each make a serial chain of 1.17 ms per
// move at the card's 1.98 GHz maximum clock.
//
// What held the first design back (101 ms a move): the joint counts were
// runtime values, so the per-joint arrays (rotations, forces, the
// Gauss-Jordan tableau, the RK4 stages) were indexed dynamically and lived
// in local memory (255 registers, 1,408 bytes of spills a thread); the
// robot sat in a by-value parameter addressed through pointers; lane 0
// alone ran the controller, the 7x14 Gauss-Jordan inverse and the 8 bias
// passes, each recomputing 7 rotations while 31 lanes waited; the 37
// chains took two rounds of 32 lanes, and each mass-matrix chain
// recomputed the true-state rotations.
//
// This design: J (joints) and NL (lanes per world, 32 or 64, from
// kernels/sim.py:k5_geometry, so that the 2 + 4J + F chains of a step run
// in one round) are template parameters and every joint loop is unrolled
// to J; F <= J stays a runtime bound, tested inside those loops, so every
// per-joint array is indexed by a constant and lives in registers (ten
// instantiations instead of 45 keep the build short).  J = 9 is the grasp
// path's Kinova with the dumbbell (F = 7, its last two bodies fixed): 45
// chains on 64 lanes; a fixed joint past F has the identity axis rotation
// and no torque, as in rnea_numeric.py.  The robot is a
// __grid_constant__ parameter, read in place.  One block of NL threads per
// world; per control step:
//   1. lane f forms joint f's measured state and references, lanes 0..J-1
//      the rotations at the measured state, lanes J..2J-1 at the true
//      state, once each, into shared memory (a chain lane then holds only
//      its own inputs: with every lane holding all references the J = 7
//      kernel needed 255 registers and 532 bytes of spills);
//   2. a lane per chain runs its RNEA pass (the nominal, the 4J
//      perturbation and the F mass-matrix chains), outputs to shared memory;
//   3. the controller on one lane (lane 32 when NL = 64, so that it runs
//      beside step 4), its sums in the first design's order;
//   4. M^-1 by Gauss-Jordan with one lane per column of [M | I] (2F lanes of
//      warp 0): the pivot row and the column of multipliers come from the
//      pivot column's lane by shuffles, and each lane updates its column;
//   5. the RK4 substeps: lane 0 runs each stage's bias pass, M^-1 (u - bias)
//      and the RK4 sums in registers, while J other lanes form the next
//      stage's rotations (stage g + 1's configuration needs only stage
//      g - 1's acceleration).  A phase clock on the card (world 0, one
//      control step) put the bias pass at ~4.3k cycles, ~1,870 float32
//      instructions on one dependent chain, and the hand-offs of an earlier
//      layout (rotations and M^-1 rows on other lanes, each through shared
//      memory and a warp barrier) at ~1.85k more a stage.
// Each RNEA pass, rotation, Gauss-Jordan element update, row of M^-1 rhs
// and RK4 sum keeps the first design's float32 operation sequence (only
// the lane that runs it changed), so K5 keeps its agreement with
// rollout_plain; no sum is reordered.  Built with -fmad=false and no fast
// math.  The accurate sinf / cosf keep their slow-path stack frame (taken
// only for |angle| > 105615 rad).
#include <cuda_runtime.h>

#define K5_MAXJ 9
#define K5_FULL 0xffffffffu

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
#pragma unroll
  for (int a = 0; a < 3; ++a) o[a] = M[3 * a] * v[0] + M[3 * a + 1] * v[1] + M[3 * a + 2] * v[2];
}

// o = M^T v
__device__ __forceinline__ void k5_mtv(const float* M, const float v[3], float o[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) o[a] = M[a] * v[0] + M[3 + a] * v[1] + M[6 + a] * v[2];
}

// R_i = rot_i @ Rot_axis(sgn * q_i) of joint i (the identity axis for a
// fixed joint or i >= F), into Rs[9]
__device__ __forceinline__ void k5_rotation(const K5Robot& rb, int i, float qi, float* Rs) {
  const int axis = rb.axes[i];
  float Ra[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  if (axis != 0 && i < rb.F) {
    const float th = (axis > 0 ? 1.0f : -1.0f) * qi;
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
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      Rs[3 * a + b] = P[3 * a] * Ra[b] + P[3 * a + 1] * Ra[3 + b] + P[3 * a + 2] * Ra[6 + b];
}

// joint i's unit axis (sign included) as three constants: e[ax] = sg
__device__ __forceinline__ void k5_axis(int axis, float e[3]) {
  const int ax = (axis > 0 ? axis : -axis) - 1;
  const float sg = axis > 0 ? 1.0f : -1.0f;
  e[0] = ax == 0 ? sg : 0.0f;
  e[1] = ax == 1 ? sg : 0.0f;
  e[2] = ax == 2 ? sg : 0.0f;
}

// link i's inertials as chain `kind` sees them (link = the perturbed link)
__device__ __forceinline__ void k5_link(const K5Robot& rb, const K5True& tr, int kind, int link,
                                        int i, float& m, float c[3], float I[9]) {
  const float* cp = (kind == K5_TRUE) ? tr.com + 3 * i : rb.com + 3 * i;
  c[0] = cp[0]; c[1] = cp[1]; c[2] = cp[2];
  if (kind == K5_NOMINAL || kind == K5_TRUE) {
    const float* Ip = (kind == K5_TRUE) ? tr.inertia + 9 * i : rb.inertia + 9 * i;
    m = (kind == K5_TRUE) ? tr.mass[i] : rb.mass[i];
#pragma unroll
    for (int k = 0; k < 9; ++k) I[k] = Ip[k];
  } else if (kind == K5_MASS_DIR) {
    m = (i == link) ? rb.mass[i] * rb.mass_unc : 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) I[k] = 0.0f;
  } else {
    m = 0.0f;
#pragma unroll
    for (int k = 0; k < 9; ++k) I[k] = (i == link) ? rb.inertia[9 * i + k] * rb.inertia_unc : 0.0f;
  }
}

// passivity-form RNEA (rnea_numeric.py:79-168), one chain: rotations Rs,
// qd / qa / qdd and tau (entries i < F set) all in registers
template <int J>
__device__ __forceinline__ void k5_rnea(const K5Robot& rb, const K5True& tr,
                                        const float (&Rs)[J][9], const float* qd,
                                        const float* qa, const float* qdd, int kind, int link,
                                        bool grav, bool arm, float* tau) {
  const int F = rb.F;
  float w[3] = {0.f, 0.f, 0.f}, wa[3] = {0.f, 0.f, 0.f}, wd[3] = {0.f, 0.f, 0.f};
  float acc[3] = {0.f, 0.f, grav ? rb.gravity : 0.f};
  float Fv[J][3], Nv[J][3];
#pragma unroll
  for (int i = 0; i < J; ++i) {
    const float* tri = rb.trans + 3 * i;
    float t0[3], t1[3], t2[3], s[3];
    k5_cross(wd, tri, t0);
    k5_cross(wa, tri, t1);
    k5_cross(w, t1, t2);
#pragma unroll
    for (int a = 0; a < 3; ++a) s[a] = acc[a] + t0[a] + t2[a];
    k5_mtv(Rs[i], s, acc);
    float tmp[3];
    k5_mtv(Rs[i], w, tmp); w[0] = tmp[0]; w[1] = tmp[1]; w[2] = tmp[2];
    k5_mtv(Rs[i], wa, tmp); wa[0] = tmp[0]; wa[1] = tmp[1]; wa[2] = tmp[2];
    k5_mtv(Rs[i], wd, tmp); wd[0] = tmp[0]; wd[1] = tmp[1]; wd[2] = tmp[2];
    const int axis = rb.axes[i];
    if (axis != 0 && i < F) {
      float e[3];
      k5_axis(axis, e);
      float eq[3], eqdd[3], c1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        eq[a] = e[a] * qd[i];
        eqdd[a] = e[a] * qdd[i];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) w[a] = w[a] + eq[a];
      k5_cross(wa, eq, c1);
#pragma unroll
      for (int a = 0; a < 3; ++a) wd[a] = wd[a] + c1[a] + eqdd[a];
#pragma unroll
      for (int a = 0; a < 3; ++a) wa[a] = wa[a] + e[a] * qa[i];
    }
    float m, cb[3], Ib[9];
    k5_link(rb, tr, kind, link, i, m, cb, Ib);
    float c0[3], c2[3], c3[3];
    k5_cross(wd, cb, c0);
    k5_cross(wa, cb, c2);
    k5_cross(w, c2, c3);
#pragma unroll
    for (int a = 0; a < 3; ++a) Fv[i][a] = m * (acc[a] + c0[a] + c3[a]);
    float Iw[3], Iwd[3], c4[3];
    k5_mv(Ib, wd, Iwd);
    k5_mv(Ib, w, Iw);
    k5_cross(wa, Iw, c4);
#pragma unroll
    for (int a = 0; a < 3; ++a) Nv[i][a] = Iwd[a] + c4[a];
  }
  float f[3] = {0.f, 0.f, 0.f}, n[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = J - 1; i >= 0; --i) {
    float rf[3], rn[3];
    if (i + 1 < J) {
      k5_mv(Rs[i + 1], f, rf);
      k5_mv(Rs[i + 1], n, rn);
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a) { rf[a] = f[a]; rn[a] = n[a]; }
    }
    float cb[3];
    const float* cp = (kind == K5_TRUE) ? tr.com + 3 * i : rb.com + 3 * i;
    cb[0] = cp[0]; cb[1] = cp[1]; cb[2] = cp[2];
    float c0[3], c1[3];
    k5_cross(cb, Fv[i], c0);
    k5_cross(rb.trans + 3 * (i + 1), rf, c1);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      n[a] = Nv[i][a] + rn[a] + c0[a] + c1[a];
      f[a] = rf[a] + Fv[i][a];
    }
    const int axis = rb.axes[i];
    if (axis != 0 && i < F) {
      float e[3];
      k5_axis(axis, e);
      const float sg = axis > 0 ? 1.0f : -1.0f;
      const float nax = e[0] != 0.0f ? n[0] : e[1] != 0.0f ? n[1] : n[2];
      float t = sg * nax;
      if (arm) t = t + rb.armature[i] * qdd[i];
      if (rb.damping[i] != 0.0f) t = t + rb.damping[i] * qd[i];
      tau[i] = t;
    }
  }
}

template <int J, int NL>
__global__ void __launch_bounds__(NL) k5_kernel(const __grid_constant__ K5Args args) {
  constexpr int NCH = 2 + 5 * J;               // chains of a step at F = J
  const K5Robot& rb = args.rb;
  const int w = blockIdx.x;
  const int lane = threadIdx.x;
  const int F = rb.F, n = args.n;
  const int n_chains = 2 + 4 * J + F;
  constexpr int CTRL = NL > 32 ? 32 : 0;       // the controller's lane

  __shared__ K5True tr;
  __shared__ float sq[J], sqd[J];              // the true state
  __shared__ float Rm[J][9], Rt[J][9];         // rotations at the measured and true states
  __shared__ float Rb[2][J][9], sx[2][J];      // RK4 stages: rotations, configurations
  __shared__ float stau[NCH][J];
  __shared__ float su[J], sMinv[J][J];
  __shared__ float sref[6][J];                 // qd, qd_ref, qdd_ref, r, err, derr (measured)

  for (int k = lane; k < J; k += NL) tr.mass[k] = args.tmass[w * J + k];
  for (int k = lane; k < 3 * J; k += NL) tr.com[k] = args.tcom[w * 3 * J + k];
  for (int k = lane; k < 9 * J; k += NL) tr.inertia[k] = args.tinertia[w * 9 * J + k];
  for (int k = lane; k < F; k += NL) {
    sq[k] = args.q0[w * F + k];
    sqd[k] = args.qd0[w * F + k];
  }
  float e_acc = 0.0f;          // althoff E(t), on the controller's lane
  __syncthreads();

#pragma unroll 1
  for (int s = 0; s < n; ++s) {
    const long long row = ((long long)w * n + s) * F;
    const long long nb = (((long long)w * n + s) * 2) * F;
    // 1. measured state and the controller's references, lane f for joint
    //    f, into shared memory; the rotations at the measured (lanes
    //    0..J-1) and true (J..2J-1) states
    if (lane < F) {
      const int f = lane;
      float qm = sq[f];
      float qdm = sqd[f];
      if (args.noise != nullptr) {
        qm = sq[f] + args.noise[nb + f];
        qdm = sqd[f] + args.noise[nb + F + f];
      }
      const float err = args.q_des[row + f] - qm;
      const float derr = args.qd_des[row + f] - qdm;
      sref[0][f] = qdm;
      sref[1][f] = args.qd_des[row + f] + args.k_r * err;
      sref[2][f] = args.qdd_des[row + f] + args.k_r * derr;
      sref[3][f] = derr + args.k_r * err;
      sref[4][f] = err;
      sref[5][f] = derr;
    }
    if (lane < 2 * J) {
      const int i = lane < J ? lane : lane - J;
      float qi = i < F ? sq[i] : 0.0f;
      if (lane < J && i < F && args.noise != nullptr) qi = sq[i] + args.noise[nb + i];
      k5_rotation(rb, i, qi, lane < J ? Rm[i] : Rt[i]);
    }
    __syncthreads();

    // 2. the step's independent RNEA chains, a lane each
#pragma unroll 1
    for (int c = lane; c < n_chains; c += NL) {
      const bool at_qd = c == 0 || (c >= 2 && c < 2 + 2 * J);   // (qd, qd_ref, qdd_ref)
      const bool mass_col = c >= 2 + 4 * J;                     // M(q)'s column j
      const int j = c - 2 - 4 * J;
      float vq[J], va[J], vdd[J], tau[J];
#pragma unroll
      for (int f = 0; f < J; ++f) {
        const bool on = f < F;
        vq[f] = at_qd && on ? sref[0][f] : 0.0f;
        va[f] = at_qd && on ? sref[1][f] : 0.0f;
        vdd[f] = !on ? 0.0f : at_qd ? sref[2][f] : mass_col ? (f == j ? 1.0f : 0.0f)
                                                            : sref[3][f];
        tau[f] = 0.0f;
      }
      int kind = K5_NOMINAL, link = -1;
      if (mass_col) {
        kind = K5_TRUE;
      } else if (c >= 2) {
        const int p = (c - 2) % (2 * J);
        kind = p < J ? K5_MASS_DIR : K5_INERTIA_DIR;
        link = p < J ? p : p - J;
      }
      const bool grav = c != 1 && !mass_col;
      const bool arm = c < 2 || mass_col;
      float R[J][9];                           // the rotations, loaded up front
#pragma unroll
      for (int i = 0; i < J; ++i)
#pragma unroll
        for (int k = 0; k < 9; ++k) R[i][k] = mass_col ? Rt[i][k] : Rm[i][k];
      k5_rnea<J>(rb, tr, R, vq, va, vdd, kind, link, grav, arm, tau);
#pragma unroll
      for (int f = 0; f < J; ++f)
        if (f < F) stau[c][f] = tau[f];
    }
    __syncthreads();

    // 3. the controller (one lane, the first design's order)
    if (lane == CTRL) {
      float u[J], r[J], err[J], derr[J];
#pragma unroll
      for (int f = 0; f < J; ++f) {
        r[f] = f < F ? sref[3][f] : 0.0f;
        err[f] = f < F ? sref[4][f] : 0.0f;
        derr[f] = f < F ? sref[5][f] : 0.0f;
      }
      const float* tau = stau[0];
      if (args.controller == 1) {
#pragma unroll
        for (int f = 0; f < J; ++f) u[f] = f < F ? tau[f] : 0.0f;
      } else {
        float dist_sup[J];
#pragma unroll
        for (int f = 0; f < J; ++f) {
          float a = 0.0f;
#pragma unroll
          for (int p = 0; p < 2 * J; ++p) a = a + fabsf(stau[2 + p][f < F ? f : 0]);
          dist_sup[f] = a;
        }
        if (args.controller == 0) {
          float rho = 0.0f, vn = 0.0f, r_sq = 0.0f, vp = 0.0f;
#pragma unroll
          for (int f = 0; f < J; ++f)
            if (f < F) rho = rho + fabsf(r[f]) * dist_sup[f];
#pragma unroll
          for (int f = 0; f < J; ++f)
            if (f < F) vn = vn + r[f] * stau[1][f];
#pragma unroll
          for (int p = 0; p < 2 * J; ++p) {
            float d = 0.0f;
#pragma unroll
            for (int f = 0; f < J; ++f)
              if (f < F) d = d + stau[2 + 2 * J + p][f] * r[f];
            vp = vp + fabsf(d);
          }
#pragma unroll
          for (int f = 0; f < J; ++f)
            if (f < F) r_sq = r_sq + r[f] * r[f];
          const float v_sup = 0.5f * vn + 0.5f * vp;
          const float hh = args.v_max - v_sup;
          const float lam = fmaxf((-args.alpha * hh + rho) / fmaxf(r_sq, 1e-12f), 0.0f);
#pragma unroll
          for (int f = 0; f < J; ++f)
            u[f] = f < F ? tau[f] + (r_sq > 0.0f ? lam * r[f] : 0.0f) : 0.0f;
        } else {
          float bn = 0.0f, es = 0.0f, ds = 0.0f;
#pragma unroll
          for (int f = 0; f < J; ++f)
            if (f < F) bn = bn + dist_sup[f] * dist_sup[f];
          bn = sqrtf(bn);
#pragma unroll
          for (int f = 0; f < J; ++f)
            if (f < F) es = es + err[f] * err[f];
#pragma unroll
          for (int f = 0; f < J; ++f)
            if (f < F) ds = ds + derr[f] * derr[f];
          const float state_err = sqrtf(es + ds);
          e_acc = e_acc + (state_err > args.max_error ? state_err * args.dt : 0.0f);
          const float phi = args.kp0 + args.ki0 * e_acc;
          const float kappa = args.kp1 + args.ki1 * e_acc;
          const float gain = kappa * bn + phi;
#pragma unroll
          for (int f = 0; f < J; ++f) u[f] = f < F ? tau[f] + gain * r[f] : 0.0f;
        }
      }
#pragma unroll
      for (int f = 0; f < J; ++f)
        if (f < F) su[f] = u[f];
    }

    // 4. M(q) (true inertials) and its inverse: Gauss-Jordan with partial
    //    pivoting, lane k < 2F holding column k of [M | I]
    if (lane < 32) {
      float col[J];
#pragma unroll
      for (int i = 0; i < J; ++i) {
        col[i] = 0.0f;
        if (i < F) {
          if (lane < F) col[i] = stau[2 + 4 * J + lane][i];
          else col[i] = (lane - F == i) ? 1.0f : 0.0f;
        }
      }
#pragma unroll
      for (int c = 0; c < J; ++c) {
        if (c >= F) break;
        int p = c;
        float best = fabsf(col[c]);
#pragma unroll
        for (int i = c + 1; i < J; ++i) {
          if (i < F && fabsf(col[i]) > best) { best = fabsf(col[i]); p = i; }
        }
        p = __shfl_sync(K5_FULL, p, c);
#pragma unroll
        for (int i = c + 1; i < J; ++i) {
          if (i == p) { const float t = col[c]; col[c] = col[i]; col[i] = t; }
        }
        const float d = __shfl_sync(K5_FULL, col[c], c);
        float fac[J];
#pragma unroll
        for (int i = 0; i < J; ++i) fac[i] = __shfl_sync(K5_FULL, col[i], c);
        col[c] = col[c] / d;
#pragma unroll
        for (int i = 0; i < J; ++i) {
          if (i == c || i >= F) continue;
          col[i] = col[i] - fac[i] * col[c];
        }
      }
      if (lane >= F && lane < 2 * F) {
#pragma unroll
        for (int i = 0; i < J; ++i)
          if (i < F) sMinv[i][lane - F] = col[i];
      }
    }
    __syncthreads();

    // 5. the RK4 substeps with M^-1 held.  Lane 0 runs every stage's bias
    //    pass, M^-1 (u - bias) and the RK4 sums in registers; the rotation
    //    lanes (warp 1's first J lanes, or lanes 1..J when NL = 32) form the
    //    next stage's rotations meanwhile: stage g + 1's configuration needs
    //    only stage g - 1's acceleration, so lane 0 writes it one stage
    //    ahead (double buffers sx, Rb) and the rotations leave the chain.
    {
      constexpr int ROT0 = NL > 32 ? 32 : 1;   // the first rotation lane
      const int n_st = 4 * args.substeps;
      float q[J], qd[J], u[J], vcur[J], qn[J], dq[J], dv[J];
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < J; ++f) {
          q[f] = f < F ? sq[f] : 0.0f;
          qd[f] = f < F ? sqd[f] : 0.0f;
          u[f] = f < F ? su[f] : 0.0f;
          vcur[f] = qd[f];
          sx[0][f] = q[f];
          sx[1][f] = q[f] + args.half_h * qd[f];
        }
      }
      __syncthreads();
      if (lane >= ROT0 && lane < ROT0 + J) {
        const int i = lane - ROT0;
        k5_rotation(rb, i, i < F ? sx[0][i] : 0.0f, Rb[0][i]);
      }
      __syncthreads();
#pragma unroll 1
      for (int g = 0; g < n_st; ++g) {
        const int st = g & 3;
        if (lane >= ROT0 && lane < ROT0 + J && g + 1 < n_st) {
          const int i = lane - ROT0;
          k5_rotation(rb, i, i < F ? sx[(g + 1) & 1][i] : 0.0f, Rb[(g + 1) & 1][i]);
        }
        if (lane == 0) {
          float R[J][9], zero[J], bias[J];
#pragma unroll
          for (int f = 0; f < J; ++f) {
#pragma unroll
            for (int k = 0; k < 9; ++k) R[f][k] = Rb[g & 1][f][k];
            zero[f] = 0.0f;
            bias[f] = 0.0f;
          }
          k5_rnea<J>(rb, tr, R, vcur, vcur, zero, K5_TRUE, -1, true, false, bias);
          float rhs[J];
#pragma unroll
          for (int f = 0; f < J; ++f) rhs[f] = u[f] - bias[f];
#pragma unroll
          for (int i = 0; i < J; ++i) {
            float a = 0.0f;
#pragma unroll
            for (int j = 0; j < J; ++j)
              if (i < F && j < F) a = a + sMinv[i][j] * rhs[j];
            // the RK4 sums qd + 2 v1 + 2 v2 + v3 and k0 + 2 k1 + 2 k2 + k3
            // in order, the next stage's velocity, and the configuration of
            // the stage after it
            float x;
            if (st == 0) {
              dv[i] = a;
              vcur[i] = qd[i] + args.half_h * a;
              dq[i] = qd[i] + 2.0f * vcur[i];
              x = q[i] + args.half_h * vcur[i];
            } else if (st == 1) {
              dv[i] = dv[i] + 2.0f * a;
              vcur[i] = qd[i] + args.half_h * a;
              dq[i] = dq[i] + 2.0f * vcur[i];
              x = q[i] + args.h * vcur[i];
            } else if (st == 2) {
              dv[i] = dv[i] + 2.0f * a;
              vcur[i] = qd[i] + args.h * a;
              dq[i] = dq[i] + vcur[i];
              qn[i] = q[i] + args.h6 * dq[i];
              x = qn[i];
            } else {
              dv[i] = dv[i] + a;
              q[i] = qn[i];
              qd[i] = qd[i] + args.h6 * dv[i];
              vcur[i] = qd[i];
              x = q[i] + args.half_h * qd[i];
            }
            if (i < F) sx[g & 1][i] = x;
          }
        }
        __syncthreads();
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < J; ++f) {
          if (f < F) {
            sq[f] = q[f];
            sqd[f] = qd[f];
            args.q_log[row + f] = q[f];
            args.qd_log[row + f] = qd[f];
            args.u_log[row + f] = u[f];
          }
        }
      }
    }
    __syncthreads();
  }
  for (int k = lane; k < F; k += NL) {
    args.q_out[w * F + k] = sq[k];
    args.qd_out[w * F + k] = sqd[k];
  }
}

template <int J, int NL>
static int k5_go(const K5Args* args, void* stream) {
  k5_kernel<J, NL><<<args->W, NL, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}

// lanes: 32 or 64 threads per world (kernels/sim.py:k5_geometry)
extern "C" int k5_launch(const K5Args* args, int lanes, void* stream) {
  const int J = args->rb.J, F = args->rb.F;
  if (F < 1 || F > J || J > K5_MAXJ || 2 + 4 * J + F > lanes) return (int)cudaErrorInvalidValue;
  if (lanes == 32) {
    switch (J) {
      case 1: return k5_go<1, 32>(args, stream);
      case 2: return k5_go<2, 32>(args, stream);
      case 3: return k5_go<3, 32>(args, stream);
      case 4: return k5_go<4, 32>(args, stream);
      case 5: return k5_go<5, 32>(args, stream);
      case 6: return k5_go<6, 32>(args, stream);
      case 7: return k5_go<7, 32>(args, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (lanes == 64) {
    switch (J) {
      case 7: return k5_go<7, 64>(args, stream);
      case 8: return k5_go<8, 64>(args, stream);
      case 9: return k5_go<9, 64>(args, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
