// K12: the Bernstein (degree-5 Bezier) family's online joint reachable set.
//
// Replaces armour_tpu/jrs.py:220 build_jrs (XLA-fused in the JAX package;
// its plain PyTorch version is jrs.py:build_jrs_plain).  Per (world w,
// sub-interval t, factor f), with s in [t / T, (t + 1) / T]:
//   - the k-dependent weights' bounds: s^3 (6 s^2 - 15 s + 10) (position),
//     30 s^2 (s - 1)^2 / duration (velocity) and the acceleration's four
//     regions around its extrema 1/2 -+ sqrt(3)/6 (jrs.py:229-250);
//   - the k-independent parts of q, qd, qdd (bezier.py:q_des_k_indep,
//     qd_des_k_indep, qdd_des_k_indep) bounded from both ends and the two
//     interior critical points of each (bezier.py:102-117), those that lie
//     inside the sub-interval and are finite (jrs.py:_bound_k_indep; a rest
//     start gives 0 / 0 there);
//   - the centre angle, its radius and k coefficient, the Taylor cos / sin
//     with the interval remainder, and the velocity and acceleration
//     centres, k coefficients and radii plus the ultimate bound's terms;
// then the rotation PZs R [W, T, J+1, 3, 3] and the velocity PZs qd, qda,
// qdda [W, T, F], every coef / egen / rad entry, and the trajectory scalars
// (k_range, qd0 duration, qdd0 duration^2) [W, 3, F].  Any T >= 1.
//
// Bound on the H100 (flagship: W = 64, T = 128, J = F = 7, B = 120, E = 38):
// the outputs are ~484 MB, almost all of them the zeros of the dense PZ
// layout, so one call is ~0.145 ms at 3.35 TB/s; the ~57k elements' few
// hundred operations each are microseconds.  Bound by the bytes written.
//
// What held the first design back (a block per (world, sub-interval), 8,192
// at the flagship size; 0.254 ms, 57% of the bytes' rate): J + 1 of its 256
// threads formed the slab's joints while the rest waited at the barrier,
// then each warp wrote a row with 4-byte stores (B = 120: the fourth pass
// 24 lanes busy; E = 38: the second pass 6), in waves of blocks that formed
// and then stored together.  This design (jrs_tail.cuh: the writer, shared
// with K11): a block of K12_THREADS per G consecutive slabs, its threads a
// (slab, joint) each forming them at once, then 16-byte streaming stores
// of each output's flat range; at the flagship size G = 16, 512 blocks,
// all resident (K12_BLOCKS_PER_SM caps the registers so that four fit an
// SM): one short pass of forming, then the stores.
//
// The float32 arithmetic repeats the plain version operation by operation,
// left to right as Python evaluates it (6.0 * Tqd0 * s**3 is (6 Tqd0) s^3).
// torch.pow on a CUDA tensor is x * x for the exponent 2, (x * x) * x for 3
// and powf otherwise (ATen's pow_tensor_scalar_kernel); k12_pow does the
// same.  The divisions are IEEE divisions by duration and duration^2 (the
// plain version divides through utils.div).  Its constants arrive as the
// plain version rounds them: Python doubles (1 / T, duration, duration^2,
// 1/2 -+ sqrt(3)/6, k_range, the ultimate bound's radii) rounded once to
// float32.  Built without fast math and with -fmad=false.
#include <cuda_runtime.h>

#include "jrs_tail.cuh"

#define K12_THREADS 256
#define K12_BLOCKS_PER_SM 4      // the register cap that keeps four blocks an SM

struct K12Args {
  const float* q0;            // [W, F]
  const float* qd0;           // [W, F]
  const float* qdd0;          // [W, F]
  float* R_coef;              // [W, T, J+1, 3, 3, B]
  float* R_egen;              // [W, T, J+1, 3, 3, E]
  float* R_rad;               // [W, T, J+1, 3, 3]
  float* v_coef;              // [3, W, T, F, B]: qd, qda, qdda
  float* v_egen;              // [3, W, T, F, E]
  float* v_rad;               // [3, W, T, F]
  float* traj;                // [W, 3, F]: k_range, qd0 duration, qdd0 duration^2
  int W, T, J, F, B, E;
  int e_cos, e_sin;           // error columns of joint 0's cos / sin error
  int e_qde, e_qdae, e_qddae; // error columns of factor 0's velocity errors
  int lin[JRS_MAXF];          // basis column of k_f
  int axis[JRS_MAXJ];         // signed joint axis, 0 fixed
  float rotm[JRS_MAXJ * 9];   // joint rotations, row-major
  float k_range[JRS_MAXF];    // the parameter range of each factor
  JrsTrig trig;
  float ds;                   // 1 / T
  float dur, dur2;            // duration, duration * duration
  float acc_max, acc_min;     // 1/2 - sqrt(3)/6, 1/2 + sqrt(3)/6
  float qe, qde, qdae, qddae; // ultimate-bound radii
};

// torch.pow(x, e) on a CUDA tensor
__device__ __forceinline__ float k12_pow(float x, int e) {
  if (e == 2) return x * x;
  if (e == 3) return x * x * x;
  return powf(x, (float)e);
}

// bezier.py:q_des_k_indep
__device__ __forceinline__ float k12_q(const K12Args&, float q0, float T, float TT, float s) {
  float v = q0 + T * s;
  v = v - (6.0f * T) * k12_pow(s, 3);
  v = v + (8.0f * T) * k12_pow(s, 4);
  v = v - (3.0f * T) * k12_pow(s, 5);
  v = v + (0.5f * TT) * k12_pow(s, 2);
  v = v - (1.5f * TT) * k12_pow(s, 3);
  v = v + (1.5f * TT) * k12_pow(s, 4);
  v = v - (0.5f * TT) * k12_pow(s, 5);
  return v;
}

// bezier.py:qd_des_k_indep
__device__ __forceinline__ float k12_qd(const K12Args& a, float, float T, float TT, float s) {
  float in = 2.0f * T + (4.0f * T) * s;
  in = in + (2.0f * TT) * s;
  in = in - (30.0f * T) * k12_pow(s, 2);
  in = in - (5.0f * TT) * k12_pow(s, 2);
  return ((0.5f * k12_pow(s - 1.0f, 2)) * in) / a.dur;
}

// bezier.py:qdd_des_k_indep
__device__ __forceinline__ float k12_qdd(const K12Args& a, float, float T, float TT, float s) {
  const float c1 = 36.0f * T + 8.0f * TT;
  const float c2 = 60.0f * T + 10.0f * TT;
  const float in = (TT - c1 * s) + c2 * k12_pow(s, 2);
  return ((-(s - 1.0f)) * in) / a.dur2;
}

// the interior critical points of each k-independent part
// (bezier.py:q_des_k_indep_extrema, qd_..., qdd_...): p = 0, 1, 2
__device__ __forceinline__ void k12_extrema(int p, float T, float TT, float* e) {
  float disc, num;
  if (p == 0) {
    disc = sqrtf((64.0f * k12_pow(T, 2) + (14.0f * T) * TT) + k12_pow(TT, 2));
    num = 2.0f * T + TT;
    const float den = 5.0f * (6.0f * T + TT);
    e[0] = (num + disc) / den;
    e[1] = (num - disc) / den;
    return;
  }
  if (p == 1) {
    disc = sqrtf(6.0f * ((54.0f * k12_pow(T, 2) + (14.0f * T) * TT) + k12_pow(TT, 2)));
    num = 18.0f * T + 4.0f * TT;
  } else {
    disc = sqrtf(2.0f * ((152.0f * k12_pow(T, 2) + (42.0f * T) * TT)
                         + 3.0f * k12_pow(TT, 2)));
    num = 32.0f * T + 6.0f * TT;
  }
  const float den = 10.0f * (6.0f * T + TT);
  e[0] = (num + disc) / den;
  e[1] = (num - disc) / den;
}

__device__ __forceinline__ float k12_part(const K12Args& a, int p, float q0, float T, float TT,
                                          float s) {
  return p == 0 ? k12_q(a, q0, T, TT, s) : p == 1 ? k12_qd(a, q0, T, TT, s)
                                                  : k12_qdd(a, q0, T, TT, s);
}

// jrs.py:_bound_k_indep of part p over [slb, sub]: (lo, hi)
__device__ __forceinline__ void k12_bound(const K12Args& a, int p, float q0, float T, float TT,
                                          float slb, float sub, float* lo, float* hi) {
  const float v_lb = k12_part(a, p, q0, T, TT, slb);
  const float v_ub = k12_part(a, p, q0, T, TT, sub);
  float l = fminf(v_lb, v_ub), h = fmaxf(v_lb, v_ub);
  float e[2];
  k12_extrema(p, T, TT, e);
  for (int i = 0; i < 2; ++i) {
    const float ve = k12_part(a, p, q0, T, TT, e[i]);
    const bool inside = (slb < e[i]) && (e[i] < sub) && isfinite(e[i]) && isfinite(ve);
    if (inside) {
      l = fminf(l, ve);
      h = fmaxf(h, ve);
    }
  }
  *lo = l;
  *hi = h;
}

// jrs.py's k-dependent position weight s^3 (6 s^2 - 15 s + 10)
__device__ __forceinline__ float k12_kd(float s) {
  return k12_pow(s, 3) * ((6.0f * k12_pow(s, 2) - 15.0f * s) + 10.0f);
}

// jrs.py's k-dependent velocity weight 30 s^2 (s - 1)^2 / duration
__device__ __forceinline__ float k12_vd(const K12Args& a, float s) {
  return ((30.0f * k12_pow(s, 2)) * k12_pow(s - 1.0f, 2)) / a.dur;
}

// jrs.py's acc: 60 s (2 s^2 - 3 s + 1) / duration^2
__device__ __forceinline__ float k12_acc(const K12Args& a, float s) {
  return ((60.0f * s) * ((2.0f * k12_pow(s, 2) - 3.0f * s) + 1.0f)) / a.dur2;
}

// Factor f of sub-interval t: the trig data trig[6] and vel[p][3] (centre,
// k coefficient, error radius of qd, qda, qdda).
__device__ void k12_element(const K12Args& a, float q0, float T, float TT, float kr, int t,
                            float* trig, float vel[3][3]) {
  const float slb = (float)t * a.ds;
  const float sub = slb + a.ds;
  float lo, hi;

  // ---- position: cos / sin PZs ----
  const float kd_lb = k12_kd(slb), kd_ub = k12_kd(sub);
  const float kd_center = (kd_ub + kd_lb) * 0.5f;
  const float kd_radius = ((kd_ub - kd_lb) * 0.5f) * kr;
  k12_bound(a, 0, q0, T, TT, slb, sub, &lo, &hi);
  const float qc = (hi + lo) * 0.5f;
  const float Rq = (kd_radius + (hi - lo) * 0.5f) + a.qe;
  jrs_trig_taylor(qc, Rq, kd_center * kr, a.trig, trig);

  // ---- velocity ----
  const float v_lb = k12_vd(a, slb), v_ub = k12_vd(a, sub);
  const float v_lo = fminf(v_lb, v_ub), v_hi = fmaxf(v_lb, v_ub);
  const float vd_center = ((v_hi + v_lo) * 0.5f) * kr;
  const float vd_radius = ((v_hi - v_lo) * 0.5f) * kr;
  k12_bound(a, 1, q0, T, TT, slb, sub, &lo, &hi);
  const float qd_center = (hi + lo) * 0.5f;
  const float v_rad = vd_radius + (hi - lo) * 0.5f;

  // ---- acceleration: the four regions of the k-dependent weight ----
  const float t_lb = k12_acc(a, slb), t_ub = k12_acc(a, sub);
  const float aA = k12_acc(a, a.acc_max), aB = k12_acc(a, a.acc_min);
  const bool r1 = sub <= a.acc_max;
  const bool r2 = !r1 && slb <= a.acc_max;
  const bool r3 = !r1 && !r2 && sub <= a.acc_min;
  const bool r4 = !r1 && !r2 && !r3 && slb <= a.acc_min;
  const float a_lo = r1 ? t_lb : r2 ? fminf(t_lb, t_ub) : r3 ? t_ub : r4 ? aB : t_lb;
  const float a_hi = r1 ? t_ub : r2 ? aA : r3 ? t_lb : r4 ? fmaxf(t_lb, t_ub) : t_ub;
  const float ad_center = ((a_hi + a_lo) * 0.5f) * kr;
  const float ad_radius = ((a_hi - a_lo) * 0.5f) * kr;
  k12_bound(a, 2, q0, T, TT, slb, sub, &lo, &hi);
  const float qdd_center = (hi + lo) * 0.5f;

  vel[0][0] = qd_center; vel[0][1] = vd_center; vel[0][2] = v_rad + a.qde;
  vel[1][0] = qd_center; vel[1][1] = vd_center; vel[1][2] = v_rad + a.qdae;
  vel[2][0] = qdd_center; vel[2][1] = ad_center;
  vel[2][2] = (ad_radius + (hi - lo) * 0.5f) + a.qddae;
}

// Joint j of slab wt (world w, sub-interval t) into rot [4][9] and, for an
// actuated joint, vel [p][x][j]: factor j's element, its trig tail and four
// matrices (and, at t = 0, its trajectory scalars); a fixed joint's
// rotation; the identity at j = J.
__device__ void k12_joint(const K12Args& a, long long wt, int j, float (*rot)[9],
                          float (*vel)[3][JRS_MAXF]) {
  const int w = (int)(wt / a.T), t = (int)(wt - (long long)w * a.T);
  float m[4][9];
  if (j < a.F) {
    float trig[6], v[3][3];
    const long long i = (long long)w * a.F + j;
    const float q0 = a.q0[i], qd0 = a.qd0[i], qdd0 = a.qdd0[i], kr = a.k_range[j];
    const float T = qd0 * a.dur;                  // Tqd0
    const float TT = (qdd0 * a.dur) * a.dur;      // TTqdd0
    k12_element(a, q0, T, TT, kr, t, trig, v);
    for (int p = 0; p < 3; ++p)
      for (int x = 0; x < 3; ++x) vel[p][x][j] = v[p][x];
    jrs_joint_mats(a.axis[j], a.rotm + j * 9, trig, m);
    if (t == 0) {
      float* tr = a.traj + (long long)w * 3 * a.F;
      tr[j] = kr;
      tr[a.F + j] = T;
      tr[2 * a.F + j] = TT;
    }
  } else if (j < a.J) {
    jrs_joint_mats(0, a.rotm + j * 9, nullptr, m);
  } else {
    const float eye[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    jrs_joint_mats(0, eye, nullptr, m);
  }
  for (int x = 0; x < 4; ++x)
    for (int e = 0; e < 9; ++e) rot[x][e] = m[x][e];
}

// A block per G consecutive slabs (grid-stride beyond the grid): a thread
// per (slab, joint) forms them, then the block writes them (jrs_tail.cuh).
__global__ void __launch_bounds__(K12_THREADS, K12_BLOCKS_PER_SM) k12_kernel(
    const __grid_constant__ K12Args a, int G) {
  __shared__ JrsSlabs sl;
  const JrsOut o = jrs_out(a);
  const int J1 = a.J + 1;
  if ((int)threadIdx.x < a.F) sl.lin[threadIdx.x] = a.lin[threadIdx.x];
  for (long long wt0 = (long long)blockIdx.x * G; wt0 < o.WT; wt0 += (long long)gridDim.x * G) {
    const int n = (int)min((long long)G, o.WT - wt0);
    for (int i = threadIdx.x; i < n * J1; i += blockDim.x) {
      const int g = i / J1, j = i - g * J1;
      k12_joint(a, wt0 + g, j, sl.rot[g][j], sl.vel[g]);
    }
    __syncthreads();
    jrs_write_slabs(o, wt0, n, sl);
    __syncthreads();                     // sl is formed again for the next slabs
  }
}

// G slabs per block (1 .. JRS_MAX_G) and the grid: kernels/jrs.py:jrs_geometry.
extern "C" int k12_launch(const K12Args* args, int G, int blocks, void* stream) {
  if (G < 1 || G > JRS_MAX_G || blocks < 1 || args->J + 1 > JRS_MAXJ || args->F > JRS_MAXF)
    return (int)cudaErrorInvalidValue;
  k12_kernel<<<(unsigned int)blocks, K12_THREADS, 0, (cudaStream_t)stream>>>(*args, G);
  return (int)cudaGetLastError();
}
