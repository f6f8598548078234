// K10: the passivity-form PZ RNEA chain, both recursions in one kernel.
//
// Replaces armour_tpu/dynamics.py:160-222 (fwd_body) and :226-256
// (bwd_body) with the structured products they call (bpz.py:189
// mul_interval, :341 matmul_interval, :487 cross_const, :507 matvec_cvec,
// :517 cross_pz_const, the pair-table cross of :120 and matmul_linear of
// :214).  For every (world, time) element the forward recursion carries
// w, w_aux, wdot and the linear acceleration through the J joints (rotated
// together as one 3x4 product by Rt_i = R_i^T), forms each link's force
// F_i = m_i f_arg and moment N_i = I_i wdot + w_aux x (I_i w) for the P
// parameter sets (nominal, interval: P <= 2) that share the kinematics,
// and the backward recursion accumulates the wrenches (f, n), rotated by
// R_{i+1}, and reads u_i = e_i . n + armature qdda_i + damping qd_i.
// Writes u [W, P, T, F] (coef, egen, rad); torque_frs's assembly
// (disturbance interval, rho, nominal reduce, radius) stays in torch.
//
// Not taken here: an uncertain centre of mass (robot.com_uncertainty > 0
// with an interval set), whose F_i and N_i need PZ x PZ crosses with the
// COM PZ.  dynamics.rnea_pz_sets routes that robot, by its field, to the
// op-level kernels K1 / K2; the Kinova flagship has it off.
//
// R is read in full (all B coefficients, as the plain matmul_linear_plain
// reads it); only coefficient 0 and the linear ones enter the products,
// the JRS writes R of degree <= 1.
//
// Bound on the H100 (flagship, W = 64, T = 128, B = 120, E = 38, J = 7,
// P = 2): each element reads R (72 entries; Rt is R transposed, read
// through the view) and qd, qda, qdda (21 entries), 59 KB, and writes u
// (14 entries, 8.9 KB): ~0.56 GB per call, ~0.17 ms at 3.35 TB/s; the
// ~1.3 MFLOP per element (~10.6 GFLOP per call) take ~0.16 ms at
// 67 TFLOP/s.
//
// Design: one block per element, 256 threads.  Shared memory holds, as
// packed PZ entries (ld = B + E + 1 floats): the kinematic carry (two 3x4
// buffers, reused for the backward (f | n) carry of the P sets), R_i, the
// temporaries, and F_i / N_i of every joint and set (J P 6 entries: 84 at
// the flagship, 53 KB), so the backward pass reads them on chip and
// nothing but u goes to device memory.  ~100 KB of dynamic shared memory
// per block at the flagship widths: two blocks per SM.  Every product is a
// pz_ops.cuh op (the code of K1 and K2), its abs masses block reductions
// in a fixed order, so repeated calls give the same bits.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"

#define K10_THREADS 256
#define K10_MAXJ 8
#define K10_MAXP 2

struct K10Args {
  const float* rc;   // R coef [W, T, J+1, 3, 3, B]
  const float* re;
  const float* rr;
  const float* qc;   // qd coef [W, T, J, B]
  const float* qe;
  const float* qr;
  const float* ac;   // qda
  const float* ae;
  const float* ar;
  const float* dc;   // qdda
  const float* de;
  const float* dr;
  float* uc;         // u coef [W, P, T, J, B]
  float* ue;
  float* ur;
  int T, J, P;
  float slop, gravity;
  float trans[K10_MAXJ + 1][3];
  float com[K10_MAXJ][3];
  float mc[K10_MAXJ][K10_MAXP];      // mass interval (centre, radius)
  float mr[K10_MAXJ][K10_MAXP];
  float Ic[K10_MAXJ][K10_MAXP][9];   // inertia interval (centre, radius)
  float Ir[K10_MAXJ][K10_MAXP][9];
  int ax[K10_MAXJ];                  // motion axis
  float sgn[K10_MAXJ], rv[K10_MAXJ], arm[K10_MAXJ], damp[K10_MAXJ];
};

#define K10_CONST (3 * (K10_MAXJ + 1) + 3 * K10_MAXJ + 18 * K10_MAXJ * K10_MAXP)

__global__ void __launch_bounds__(K10_THREADS) k10_kernel(const K10Args args) {
  extern __shared__ float4 k10_smem[];
  unsigned char* tab = (unsigned char*)k10_smem;
  float* red = (float*)(tab + PZ_TAB_BYTES);
  float* mass = red + PZ_RED_FLOATS;
  float* trans = mass + 4 * PZ_MAXMASS;          // [J+1, 3]
  float* com = trans + 3 * (K10_MAXJ + 1);       // [J, 3]
  float* Ic = com + 3 * K10_MAXJ;                // [J, P, 9]
  float* Ir = Ic + 9 * K10_MAXJ * K10_MAXP;
  float* ent = Ir + 9 * K10_MAXJ * K10_MAXP;
  PZCtx c;
  pz_ctx_init(c, tab, red, mass);
  const int B = c.B, E = c.E, ld = c.ld, rix = B + E;
  const int J = args.J, P = args.P, T = args.T;
  float* kc = ent;                // carry: two buffers of 12 entries
  float* rm = kc + 24 * ld;       // R_i or R_{i+1}, 9
  float* ta = rm + 9 * ld;        // temporaries, 3 each
  float* tb = ta + 3 * ld;
  float* tc = tb + 3 * ld;
  float* qv = tc + 3 * ld;
  float* qs = qv + 3 * ld;        // qd_i, qda_i, qdda_i
  float* iw = qs + 3 * ld;        // I w products, 3x2
  float* fn = iw + 6 * ld;        // F_i, N_i [J, P, 2, 3]
  const long long e = blockIdx.x;
  const long long w = e / T, t = e % T;

  for (int i = threadIdx.x; i < 3 * (J + 1); i += blockDim.x) trans[i] = args.trans[i / 3][i % 3];
  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x) com[i] = args.com[i / 3][i % 3];
  for (int i = threadIdx.x; i < 9 * J * P; i += blockDim.x) {
    const int j = i / (9 * P), p = (i / 9) % P, q = i % 9;
    Ic[i] = args.Ic[j][p][q];
    Ir[i] = args.Ir[j][p][q];
  }
  // kinematic carry, columns (wdot | w | w_aux | lin_acc); lin_acc = gravity e_z
  for (int i = threadIdx.x; i < 12 * ld; i += blockDim.x)
    kc[i] = (i == (2 * 4 + 3) * ld) ? args.gravity : 0.0f;
  __syncthreads();

  const PZMat TA = pz_mat(ta, ld, 0), TB = pz_mat(tb, ld, 0), TC = pz_mat(tc, ld, 0);
  const PZMat QV = pz_mat(qv, ld, 0), IW = pz_mat(iw, 2 * ld, ld);
  const PZMat RM = pz_mat(rm, 3 * ld, ld);
  const float* qd_s = qs;
  const float* qda_s = qs + ld;
  const float* qdda_s = qs + 2 * ld;
  int cur = 0;

  // ---- forward recursion ----
  for (int i = 0; i < J; ++i) {
    PZMat K = pz_mat(kc + cur * 12 * ld, 4 * ld, ld);
    const float* tr = trans + 3 * i;
    // acc_arg = lin_acc + (wdot x trans_i + w x (w_aux x trans_i)), in place
    pz_cross_pz_const(c, pz_col(K, 2), tr, TA);
    pz_cross(c, pz_col(K, 1), TA, TB, args.slop);
    pz_cross_pz_const(c, pz_col(K, 0), tr, TC);
    pz_add(c, TC, TB, TC, 3, 1);
    pz_add(c, pz_col(K, 3), TC, pz_col(K, 3), 3, 1);
    const long long r0 = ((e * (J + 1)) + i) * 9;
    pz_load(c, rm, 9, args.rc + r0 * B, args.re + r0 * E, args.rr + r0);
    const long long q0 = e * J + i;
    pz_load(c, qs, 1, args.qc + q0 * B, args.qe + q0 * E, args.qr + q0);
    pz_load(c, qs + ld, 1, args.ac + q0 * B, args.ae + q0 * E, args.ar + q0);
    pz_load(c, qs + 2 * ld, 1, args.dc + q0 * B, args.de + q0 * E, args.dr + q0);
    __syncthreads();
    // (wdot | w | w_aux | acc) <- Rt_i (wdot | w | w_aux | acc): one 3x4 product
    const PZMat Kn = pz_mat(kc + (1 - cur) * 12 * ld, 4 * ld, ld);
    pz_matmul_linear(c, pz_t(RM), K, Kn, 3, 3, 4, args.slop);
    cur = 1 - cur;
    K = Kn;
    const PZMat WD = pz_col(K, 0), WV = pz_col(K, 1), WA = pz_col(K, 2), LA = pz_col(K, 3);
    const int ax = args.ax[i];
    const float sg = args.sgn[i], rv = args.rv[i];
    // w += e qd ; wdot += w_aux x (e qd) + e qdda ; w_aux += e qda
    pz_zero(c, QV, 3);
    pz_add_scaled_axis(c, QV, ax, sg, rv, qd_s);
    pz_add(c, WV, QV, WV, 3, 1);
    pz_cross(c, WA, QV, TA, args.slop);
    pz_add(c, WD, TA, WD, 3, 1);
    pz_add_scaled_axis(c, WD, ax, sg, rv, qdda_s);
    pz_add_scaled_axis(c, WA, ax, sg, rv, qda_s);
    // f_arg = lin_acc + (wdot x com_i + w x (w_aux x com_i)) -> TC
    const float* cm = com + 3 * i;
    pz_cross_pz_const(c, WA, cm, TA);
    pz_cross(c, WV, TA, TB, args.slop);
    pz_cross_pz_const(c, WD, cm, TC);
    pz_add(c, TC, TB, TC, 3, 1);
    pz_add(c, LA, TC, TC, 3, 1);
    for (int p = 0; p < P; ++p) {
      const PZMat Fp = pz_mat(fn + ((i * P + p) * 2 + 0) * 3 * ld, ld, 0);
      const PZMat Np = pz_mat(fn + ((i * P + p) * 2 + 1) * 3 * ld, ld, 0);
      pz_mul_interval(c, args.mc[i][p], args.mr[i][p], TC, Fp, 3, args.slop);
      // I (wdot | w): the first two carry columns
      pz_matmul_interval(c, Ic + 9 * (i * P + p), Ir + 9 * (i * P + p), K, IW, 3, 3, 2,
                         args.slop);
      pz_cross(c, WA, pz_col(IW, 1), TA, args.slop);
      pz_add(c, pz_col(IW, 0), TA, Np, 3, 1);
    }
  }

  // ---- backward recursion, last joint first; carry columns (f_p | n_p) ----
  pz_zero(c, pz_mat(kc + cur * 12 * ld, ld, 0), 12);
  for (int i = J - 1; i >= 0; --i) {
    const PZMat S = pz_mat(kc + cur * 12 * ld, 4 * ld, ld);
    const PZMat Sn = pz_mat(kc + (1 - cur) * 12 * ld, 4 * ld, ld);
    const long long r0 = ((e * (J + 1)) + i + 1) * 9;
    pz_load(c, rm, 9, args.rc + r0 * B, args.re + r0 * E, args.rr + r0);
    const long long q0 = e * J + i;
    pz_load(c, qs, 1, args.qc + q0 * B, args.qe + q0 * E, args.qr + q0);
    pz_load(c, qs + 2 * ld, 1, args.dc + q0 * B, args.de + q0 * E, args.dr + q0);
    __syncthreads();
    // (f_p | n_p) <- R_{i+1} (f_p | n_p) for every set: one 3 x 2P product
    pz_matmul_linear(c, RM, S, Sn, 3, 3, 2 * P, args.slop);
    cur = 1 - cur;
    for (int p = 0; p < P; ++p) {
      const PZMat RF = pz_col(Sn, 2 * p), RN = pz_col(Sn, 2 * p + 1);
      const PZMat Fp = pz_mat(fn + ((i * P + p) * 2 + 0) * 3 * ld, ld, 0);
      const PZMat Np = pz_mat(fn + ((i * P + p) * 2 + 1) * 3 * ld, ld, 0);
      // n = (N_i + rn) + (com_i x F_i + trans_{i+1} x rf) ; f = rf + F_i
      pz_cross_const(c, com + 3 * i, Fp, TA);
      pz_cross_const(c, trans + 3 * (i + 1), RF, TB);
      pz_add(c, TA, TB, TA, 3, 1);
      pz_add(c, Np, RN, TC, 3, 1);
      pz_add(c, TC, TA, RN, 3, 1);
      pz_add(c, RF, Fp, RF, 3, 1);
      // u_i = (sgn n[ax] + arm rv qdda_i) + damp rv qd_i
      const int ax = args.ax[i];
      const float sg = args.sgn[i];
      const float sa = args.arm[i] * args.rv[i], sd = args.damp[i] * args.rv[i];
      const float* na = pz_at(RN, ax, 0);
      const long long u0 = (w * P + p) * T * J + t * J + i;
      for (int x = threadIdx.x; x < ld; x += blockDim.x) {
        if (x < B) {
          args.uc[u0 * B + x] = (sg * na[x] + qdda_s[x] * sa) + qd_s[x] * sd;
        } else if (x < rix) {
          args.ue[u0 * E + x - B] = (sg * na[x] + qdda_s[x] * sa) + qd_s[x] * sd;
        } else {
          args.ur[u0] = (fabsf(sg) * na[x] + qdda_s[x] * fabsf(sa)) + qd_s[x] * fabsf(sd);
        }
      }
      __syncthreads();
    }
  }
}

extern "C" int k10_tables(const PZTables* t) { return pz_upload_tables(t); }

extern "C" int k10_launch(const K10Args* args, long long blocks, int ld, void* stream) {
  const int ents = 24 + 9 + 15 + 6 + 6 * args->J * args->P;
  const size_t smem = PZ_TAB_BYTES
      + sizeof(float) * (PZ_RED_FLOATS + 4 * PZ_MAXMASS + K10_CONST + ents * ld);
  cudaError_t err = cudaFuncSetAttribute(k10_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k10_kernel<<<(unsigned int)blocks, K10_THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
