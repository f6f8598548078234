// K11: the constant-acceleration (ARMTD) family's online joint reachable
// set.
//
// Replaces armour_tpu/armtd.py:77 build_jrs_armtd (XLA-fused in the JAX
// package; its plain PyTorch version is armtd.py:build_jrs_armtd_plain).
// Per (world w, sub-interval t, factor f): the phase coefficients' bounds at
// both ends of [t1, t2] (t1 = t * duration / T), g_k = min(max(pi/24,
// |qd0|/3), pi/3), the centre angle, its radius and k coefficient, the
// Taylor cos / sin with the interval remainder, and the velocity and
// acceleration centres, k coefficients and radii plus the ultimate bound's
// error terms; then the rotation PZs R [W, T, J+1, 3, 3] and the velocity
// PZs qd, qda, qdda [W, T, F], every coef / egen / rad entry, and the
// trajectory scalars (g_k, qd0 * duration, 0) [W, 3, F].
//
// Bound on the H100 (flagship: W = 64, T = 128, J = F = 7, B = 120, E = 38):
// the outputs are ~484 MB, almost all of them the zeros of the dense PZ
// layout (R's coefficients alone 283 MB), so one call is ~0.145 ms at
// 3.35 TB/s; the ~60k elements' few hundred operations each are
// microseconds.  Bound by the bytes written.
//
// Design: K12's (jrs_bernstein.cu), whose writer it shares
// (jrs_tail.cuh:jrs_write_slabs): a block of K11_THREADS per G consecutive
// (world, sub-interval) slabs, a thread per (slab, joint) forming the
// element of factor j, its trig tail and four rotation matrices (the fixed
// joints and the identity) into shared memory; then the block writes each
// output's flat range of its slabs with 16-byte streaming stores.
//
// The float32 arithmetic repeats the plain version operation by operation.
// Its constants arrive as the plain version rounds them: Python doubles
// (brk = 1 / (ts - tp), -tp * brk, 0.5 tp^2, 0.5 tp brk, pi / 24, pi / 3,
// the ultimate bound's radii) rounded once to float32.  The acceleration's
// lower end t1 + 1e-9 is a float32 add, as in the plain version, so at
// t1 = t_plan it stays t_plan and the sub-interval takes in both phases.
// Built without fast math and with -fmad=false.
#include <cuda_runtime.h>

#include "jrs_tail.cuh"

#define K11_THREADS 256
#define K11_BLOCKS_PER_SM 4      // the register cap that keeps four blocks an SM

struct K11Args {
  const float* q0;            // [W, F]
  const float* qd0;           // [W, F]
  float* R_coef;              // [W, T, J+1, 3, 3, B]
  float* R_egen;              // [W, T, J+1, 3, 3, E]
  float* R_rad;               // [W, T, J+1, 3, 3]
  float* v_coef;              // [3, W, T, F, B]: qd, qda, qdda
  float* v_egen;              // [3, W, T, F, E]
  float* v_rad;               // [3, W, T, F]
  float* traj;                // [W, 3, F]: g_k, qd0 * duration, 0
  int W, T, J, F, B, E;
  int e_cos, e_sin;           // error columns of joint 0's cos / sin error
  int e_qde, e_qdae, e_qddae; // error columns of factor 0's velocity errors
  int lin[JRS_MAXF];          // basis column of k_f
  int axis[JRS_MAXJ];         // signed joint axis, 0 fixed
  float rotm[JRS_MAXJ * 9];   // joint rotations, row-major
  JrsTrig trig;
  float step, tp, ts, eps;    // duration / T, t_plan, duration, 1e-9
  float brk, neg_tp_brk;      // 1 / (ts - tp), -tp * brk
  float half_tp2, half_tp_brk;  // 0.5 tp^2, 0.5 tp brk
  float pi24, pi3;            // g_k's bounds
  float qe, qde, qdae, qddae; // ultimate-bound radii
};

// armtd.py:_phase_coeffs at time t: (a, b) with q = q0 + a + b k
__device__ __forceinline__ void k11_coeffs(const K11Args& a, float t, float qd0, float* pa,
                                           float* pb) {
  const float tau = t - a.tp;
  if (t > a.tp) {
    *pa = ((qd0 * a.tp) + (qd0 * tau)) - ((((0.5f * qd0) * a.brk) * tau) * tau);
    *pb = (a.half_tp2 + a.tp * tau) - ((a.half_tp_brk * tau) * tau);
  } else {
    *pa = qd0 * t;
    *pb = (0.5f * t) * t;
  }
}

// armtd.py:_phase_vel: qd = a' + b' k
__device__ __forceinline__ void k11_vel(const K11Args& a, float t, float qd0, float* pa,
                                        float* pb) {
  const float tau = t - a.tp;
  if (t > a.tp) {
    *pa = qd0 * (1.0f - a.brk * tau);
    *pb = a.tp * (1.0f - a.brk * tau);
  } else {
    *pa = qd0 + 0.0f * t;
    *pb = t;
  }
}

// armtd.py:_phase_acc: qdd = a'' + b'' k
__device__ __forceinline__ void k11_acc(const K11Args& a, float t, float qd0, float* pa,
                                        float* pb) {
  if (t > a.tp) {
    *pa = (-qd0) * a.brk;
    *pb = a.neg_tp_brk + 0.0f;
  } else {
    *pa = 0.0f;
    *pb = 1.0f + 0.0f;
  }
}

// a coefficient pair's bounds over the sub-interval from its two ends:
// a in [a1, a2], b in [b1, b2]
struct K11Bounds {
  float a1, a2, b1, b2;
};

__device__ __forceinline__ K11Bounds k11_bounds(float a_lo, float b_lo, float a_hi, float b_hi) {
  return {jrs_min(a_lo, a_hi), jrs_max(a_lo, a_hi), jrs_min(b_lo, b_hi), jrs_max(b_lo, b_hi)};
}

// Factor f of sub-interval t: the trig data trig[6] and vel[p][3] (centre,
// k coefficient, error radius of qd, qda, qdda); returns g_k.
__device__ float k11_element(const K11Args& a, float q0, float qd0, int t, float* trig,
                             float vel[3][3]) {
  float x = fabsf(qd0) / 3.0f;                 // torch.clamp(|qd0| / 3, pi/24, pi/3)
  x = x < a.pi24 ? a.pi24 : x;
  const float gk = x > a.pi3 ? a.pi3 : x;
  const float t1 = (float)t * a.step;
  const float t2 = t1 + a.step;
  float alo, blo, ahi, bhi;

  k11_coeffs(a, t1, qd0, &alo, &blo);
  k11_coeffs(a, t2, qd0, &ahi, &bhi);
  K11Bounds p = k11_bounds(alo, blo, ahi, bhi);
  const float qc = q0 + (p.a1 + p.a2) * 0.5f;
  const float Rq = ((p.a2 - p.a1) * 0.5f + ((p.b2 - p.b1) * 0.5f) * gk) + a.qe;
  const float kd = ((p.b1 + p.b2) * 0.5f) * gk;
  jrs_trig_taylor(qc, Rq, kd, a.trig, trig);

  k11_vel(a, t1, qd0, &alo, &blo);
  k11_vel(a, t2, qd0, &ahi, &bhi);
  p = k11_bounds(alo, blo, ahi, bhi);
  const float vc = (p.a1 + p.a2) * 0.5f;
  const float vk = ((p.b1 + p.b2) * 0.5f) * gk;
  const float vr = (p.a2 - p.a1) * 0.5f + ((p.b2 - p.b1) * 0.5f) * gk;

  k11_acc(a, t1 + a.eps, qd0, &alo, &blo);    // a float32 add: t_plan + 1e-9 == t_plan
  k11_acc(a, t2, qd0, &ahi, &bhi);
  p = k11_bounds(alo, blo, ahi, bhi);
  const float ac = (p.a1 + p.a2) * 0.5f;
  const float ak = ((p.b1 + p.b2) * 0.5f) * gk;
  const float ar = (p.a2 - p.a1) * 0.5f + ((p.b2 - p.b1) * 0.5f) * gk;

  vel[0][0] = vc; vel[0][1] = vk; vel[0][2] = vr + a.qde;
  vel[1][0] = vc; vel[1][1] = vk; vel[1][2] = vr + a.qdae;
  vel[2][0] = ac; vel[2][1] = ak; vel[2][2] = ar + a.qddae;
  return gk;
}

// Joint j of slab wt (world w, sub-interval t) into rot [4][9] and, for an
// actuated joint, vel [p][x][j]: factor j's element (k11_element), its trig
// tail and four matrices (and, at t = 0, its trajectory scalars); a fixed
// joint's rotation; the identity at j = J.
__device__ void k11_joint(const K11Args& a, long long wt, int j, float (*rot)[9],
                          float (*vel)[3][JRS_MAXF]) {
  const int w = (int)(wt / a.T), t = (int)(wt - (long long)w * a.T);
  float m[4][9];
  if (j < a.F) {
    float trig[6], v[3][3];
    const float q0 = a.q0[(long long)w * a.F + j], qd0 = a.qd0[(long long)w * a.F + j];
    const float gk = k11_element(a, q0, qd0, t, trig, v);
    for (int p = 0; p < 3; ++p)
      for (int i = 0; i < 3; ++i) vel[p][i][j] = v[p][i];
    jrs_joint_mats(a.axis[j], a.rotm + j * 9, trig, m);
    if (t == 0) {
      float* tr = a.traj + (long long)w * 3 * a.F;
      tr[j] = gk;
      tr[a.F + j] = qd0 * a.ts;
      tr[2 * a.F + j] = 0.0f;
    }
  } else if (j < a.J) {
    jrs_joint_mats(0, a.rotm + j * 9, nullptr, m);
  } else {
    const float eye[9] = {1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f};
    jrs_joint_mats(0, eye, nullptr, m);
  }
  for (int i = 0; i < 4; ++i)
    for (int e = 0; e < 9; ++e) rot[i][e] = m[i][e];
}

// A block per G consecutive slabs (grid-stride beyond the grid): a thread
// per (slab, joint) forms them, then the block writes them (jrs_tail.cuh).
__global__ void __launch_bounds__(K11_THREADS, K11_BLOCKS_PER_SM) k11_kernel(
    const __grid_constant__ K11Args a, int G) {
  __shared__ JrsSlabs sl;
  const JrsOut o = jrs_out(a);
  const int J1 = a.J + 1;
  if ((int)threadIdx.x < a.F) sl.lin[threadIdx.x] = a.lin[threadIdx.x];
  for (long long wt0 = (long long)blockIdx.x * G; wt0 < o.WT; wt0 += (long long)gridDim.x * G) {
    const int n = (int)min((long long)G, o.WT - wt0);
    for (int i = threadIdx.x; i < n * J1; i += blockDim.x) {
      const int g = i / J1, j = i - g * J1;
      k11_joint(a, wt0 + g, j, sl.rot[g][j], sl.vel[g]);
    }
    __syncthreads();
    jrs_write_slabs(o, wt0, n, sl);
    __syncthreads();                     // sl is formed again for the next slabs
  }
}

// G slabs per block (1 .. JRS_MAX_G) and the grid: kernels/jrs.py:jrs_geometry.
extern "C" int k11_launch(const K11Args* args, int G, int blocks, void* stream) {
  if (G < 1 || G > JRS_MAX_G || blocks < 1 || args->J + 1 > JRS_MAXJ || args->F > JRS_MAXF)
    return (int)cudaErrorInvalidValue;
  k11_kernel<<<(unsigned int)blocks, K11_THREADS, 0, (cudaStream_t)stream>>>(*args, G);
  return (int)cudaGetLastError();
}
