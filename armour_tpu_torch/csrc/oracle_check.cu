// K6: the safety oracles of one move, over every logged state.
//
// Replaces armour_tpu/simulator.py:217-258 (make_oracles.check, vmapped
// over worlds by batch_sim.py:178) with its obb_obb_separated (:174-196),
// obstacle_axes_halves (:199-208) and forward_kinematics
// (rnea_numeric.py:55-76).  Per (world, logged step, link):
//   the link box: FK frame R (columns = box axes), centre p + R c_link,
//     half extents link_generators;
//   every obstacle: unit axes = generator columns / their norm (a zero
//     generator, norm <= 1e-12, gets the coordinate axis), half extents =
//     the norms; the 15-axis separating-axis test (3 link axes, 3 obstacle
//     axes, 9 cross products; an axis counts only when its norm > 1e-9);
//   an unseparated real obstacle is an overlap: flag 0 (collision) and one
//     more in the world's overlap count.
// The same thread, for link j < F, checks joint j at that step: |u| over the
// torque limit (flag 1), |q - q_des| > qe or |qd - qd_des| > qde (flag 2),
// q outside its position limits or |qd| over the speed limit (flag 3).
//
// Bound on the H100 (flagship, W = 64, n = 500, J = 7, O = 40): at most
// 8.96M (state, link, obstacle) triples x 15 axes; it reads 4.5 MB of logs
// (1.3 us at 3.35 TB/s), so it is bound by operations.  The test stops at
// the first separating axis, so the work depends on the data: chip_smoke.py
// (check_oracles, sat_axes_needed) counts what a run's logs need, with FK
// once per logged state and the obstacle axes once per world and obstacle.
//
// Design, simple first: one thread per (world, step, link), the FK chain
// recomputed in registers, obstacles read through L1, one atomic per thread
// for the count and one per raised flag.  Built with -fmad=false and no
// fast math, so that each axis test repeats the plain version's float32
// arithmetic up to the order of 3-term sums.
#include <cuda_runtime.h>

#define K6_MAXJ 8

struct K6Robot {
  int J, F;
  int axes[K6_MAXJ];
  float trans[(K6_MAXJ + 1) * 3];
  float rot[K6_MAXJ * 9];
  float link_c[K6_MAXJ * 3];
  float link_h[K6_MAXJ * 3];
  float torque_lim[K6_MAXJ];
  float pos_lb[K6_MAXJ];
  float pos_ub[K6_MAXJ];
  float speed_lim[K6_MAXJ];
  float qe, qde;
};

struct K6Args {
  K6Robot rb;
  const float* q;              // [W, N, F]
  const float* qd;
  const float* u;
  const float* q_des;
  const float* qd_des;
  const float* centers;        // [W, O, 3]
  const float* gens;           // [W, O, 3, 3] (columns = generators)
  const unsigned char* mask;   // [W, O]
  int* flags;                  // [W, 4], zeroed by the caller
  unsigned long long* overlaps;  // [W], zeroed by the caller
  int W, N, O;
};

__device__ __forceinline__ float k6_dot(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__global__ void __launch_bounds__(256) k6_kernel(const K6Args args) {
  const K6Robot& rb = args.rb;
  const int J = rb.J, F = rb.F;
  const long long total = (long long)args.W * args.N * J;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = (int)(idx % J);
  const long long ws = idx / J;            // world * N + step
  const int w = (int)(ws / args.N);
  const float* q = args.q + ws * F;

  // FK frame of link j (rnea_numeric.forward_kinematics)
  float R[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float p[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i <= j; ++i) {
    const float* t = rb.trans + 3 * i;
    float Rt[3];
    for (int a = 0; a < 3; ++a) Rt[a] = R[3 * a] * t[0] + R[3 * a + 1] * t[1] + R[3 * a + 2] * t[2];
    for (int a = 0; a < 3; ++a) p[a] = p[a] + Rt[a];
    float Ra[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    const int axis = rb.axes[i];
    if (axis != 0 && i < F) {
      const float th = (axis > 0 ? 1.0f : -1.0f) * q[i];
      const float c = cosf(th), s = sinf(th);
      const int ax = (axis > 0 ? axis : -axis) - 1;
      if (ax == 0) {
        Ra[4] = c; Ra[5] = -s; Ra[7] = s; Ra[8] = c;
      } else if (ax == 1) {
        Ra[0] = c; Ra[2] = s; Ra[6] = -s; Ra[8] = c;
      } else {
        Ra[0] = c; Ra[1] = -s; Ra[3] = s; Ra[4] = c;
      }
    }
    const float* P = rb.rot + 9 * i;
    float Ri[9], Rn[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        Ri[3 * a + b] = P[3 * a] * Ra[b] + P[3 * a + 1] * Ra[3 + b] + P[3 * a + 2] * Ra[6 + b];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        Rn[3 * a + b] = R[3 * a] * Ri[b] + R[3 * a + 1] * Ri[3 + b] + R[3 * a + 2] * Ri[6 + b];
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
  }
  const float* lc = rb.link_c + 3 * j;
  float ca[3];
  for (int a = 0; a < 3; ++a) ca[a] = p[a] + (R[3 * a] * lc[0] + R[3 * a + 1] * lc[1] + R[3 * a + 2] * lc[2]);
  float A[3][3];                           // A[i] = link box axis i (column i of R)
  for (int i = 0; i < 3; ++i)
    for (int a = 0; a < 3; ++a) A[i][a] = R[3 * a + i];
  const float* ha = rb.link_h + 3 * j;

  unsigned long long hits = 0;
  for (int o = 0; o < args.O; ++o) {
    if (!args.mask[(long long)w * args.O + o]) continue;
    const float* cbp = args.centers + ((long long)w * args.O + o) * 3;
    const float* G = args.gens + ((long long)w * args.O + o) * 9;
    float Bx[3][3], hb[3];                 // Bx[k] = obstacle axis k
    for (int k = 0; k < 3; ++k) {
      const float g[3] = {G[k], G[3 + k], G[6 + k]};
      hb[k] = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
      const bool ok = hb[k] > 1e-12f;
      const float den = fmaxf(hb[k], 1e-12f);
      for (int a = 0; a < 3; ++a) Bx[k][a] = ok ? g[a] / den : (a == k ? 1.0f : 0.0f);
    }
    const float d[3] = {cbp[0] - ca[0], cbp[1] - ca[1], cbp[2] - ca[2]};
    bool separated = false;
    for (int ax = 0; ax < 15 && !separated; ++ax) {
      float L[3];
      if (ax < 3) {
        for (int a = 0; a < 3; ++a) L[a] = A[ax][a];
      } else if (ax < 6) {
        for (int a = 0; a < 3; ++a) L[a] = Bx[ax - 3][a];
      } else {
        const float* x = A[(ax - 6) / 3];
        const float* y = Bx[(ax - 6) % 3];
        L[0] = x[1] * y[2] - x[2] * y[1];
        L[1] = x[2] * y[0] - x[0] * y[2];
        L[2] = x[0] * y[1] - x[1] * y[0];
      }
      const float nrm = sqrtf(L[0] * L[0] + L[1] * L[1] + L[2] * L[2]);
      if (!(nrm > 1e-9f)) continue;
      const float Ln[3] = {L[0] / nrm, L[1] / nrm, L[2] / nrm};
      const float ra = ha[0] * fabsf(k6_dot(A[0], Ln)) + ha[1] * fabsf(k6_dot(A[1], Ln))
                       + ha[2] * fabsf(k6_dot(A[2], Ln));
      const float rb2 = hb[0] * fabsf(k6_dot(Bx[0], Ln)) + hb[1] * fabsf(k6_dot(Bx[1], Ln))
                        + hb[2] * fabsf(k6_dot(Bx[2], Ln));
      separated = fabsf(k6_dot(d, Ln)) > ra + rb2;
    }
    if (!separated) ++hits;
  }
  if (hits) {
    atomicOr(&args.flags[4 * w + 0], 1);
    atomicAdd(&args.overlaps[w], hits);
  }

  if (j < F) {
    const long long e = ws * F + j;
    const float qv = args.q[e], qdv = args.qd[e];
    if (fabsf(args.u[e]) > rb.torque_lim[j]) atomicOr(&args.flags[4 * w + 1], 1);
    if (fabsf(qv - args.q_des[e]) > rb.qe || fabsf(qdv - args.qd_des[e]) > rb.qde)
      atomicOr(&args.flags[4 * w + 2], 1);
    if (qv < rb.pos_lb[j] || qv > rb.pos_ub[j] || fabsf(qdv) > rb.speed_lim[j])
      atomicOr(&args.flags[4 * w + 3], 1);
  }
}

extern "C" int k6_launch(const K6Args* args, void* stream) {
  if (args->rb.J > K6_MAXJ || args->rb.F > args->rb.J) return (int)cudaErrorInvalidValue;
  const long long total = (long long)args->W * args->N * args->rb.J;
  const unsigned int blocks = (unsigned int)((total + 255) / 256);
  k6_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
