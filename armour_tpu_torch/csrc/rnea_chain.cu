// K10: the passivity-form PZ RNEA chain, both recursions in one kernel.
//
// Replaces armour_tpu/dynamics.py:160-222 (fwd_body) and :226-256
// (bwd_body) with the structured products they call (bpz.py:189
// mul_interval, :341 matmul_interval, :487 cross_const, :507 matvec_cvec,
// :517 cross_pz_const, the pair-table cross of :120 and matmul_linear of
// :214).  For every (world, time) element the forward recursion carries
// w, w_aux, wdot and the linear acceleration through the J joints (rotated
// by Rt_i = R_i^T), forms each link's force F_i = m_i f_arg and moment
// N_i = I_i wdot + w_aux x (I_i w) for the P parameter sets (nominal,
// interval: P <= 2) that share the kinematics, and the backward recursion
// accumulates the wrenches (f, n), rotated by R_{i+1}, and reads
// u_i = e_i . n + armature qdda_i + damping qd_i.  Writes u [W, P, T, F]
// (coef, egen, rad), and, when asked (wj >= 0), the wrench (f, n) after
// joint wj [W, P, T, 3] (dynamics.py:268-279: the contact wrench of the
// grasp rows, kernel K16), from the same pass.  Joints past F (the
// trailing fixed joints of the dumbbell payload, J = 9, F = 7) have no
// motion axis (rv = 0) and read a zero row for qd / qda / qdda, as
// dynamics.py:142-151 pads them.
//
// Not taken here: an uncertain centre of mass (robot.com_uncertainty > 0
// with an interval set), whose F_i and N_i need PZ x PZ crosses with the
// COM PZ.  dynamics.rnea_pz_sets routes that robot, by its field, to the
// op-level kernels K1 / K2; the Kinova flagship has it off.
//
// Bound on the H100 (flagship, W = 64, T = 128, B = 120, E = 38, J = 7,
// P = 2): each element reads R (72 entries) and qd, qda, qdda (21
// entries), 59 KB, and writes u (14 entries, 8.9 KB): ~0.56 GB per call,
// ~0.17 ms at 3.35 TB/s.  Its ~2.2 M float32 operations per element, 17.7
// G per call (every op as the plain version writes it), take 0.26 ms at
// the 67 TFLOP/s that counts an FMA as two operations, and 0.53 ms at the
// 33.5 T operations/s of separate multiplies and adds, which is the rate
// that applies here: built with -fmad=false, nothing is contracted.
// Bound by operations.
//
// Design: a group of G threads per element (one warp; two below 8
// elements an SM; eight, one element a block, for the W = 1 planner's 128
// elements), NG elements per block, and a persistent grid that walks the
// elements; every pz_ops.cuh op runs over the group and ends with the
// group's barrier (__syncwarp, or a named barrier), so no element waits
// for another and there is no block-wide barrier after the tables are
// staged.  Per element, shared memory holds 17.6 KB at the flagship widths:
//   - the carry as five 3-entry column slots (four columns and a spare): a
//     rotation maps one column at a time into the spare, then the slots
//     swap, so no second carry buffer is needed;
//   - three 3-entry temporaries: chains of elementwise ops are fused
//     (pz_add_cross_pz_const; the whole backward wrench update and the
//     torque read-out are one pass), and the inertia product is formed a
//     column at a time;
//   - R_i in compact form (coefficient 0, the nf linear ones, egen, rad and
//     its abs masses, taken over all B coefficients once at the load, as
//     the plain matmul_linear takes them): 52 floats an entry, not 159,
//     its coefficients read as two 16-byte loads;
//   - the group's mass scratch.
// F_i and N_i of the forward pass (J P 6 entries, 53 KB an element) go to
// a global scratch per resident group, which stays in L2; qd, qda, qdda
// are read from device memory where they are used.  The abs masses are
// warp shuffles in a fixed order, so repeated calls give the same bits.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"

#define K10_MAXJ 9
#define K10_MAXP 2
#define K10_SLOTS 5        // carry columns: four and a spare
#define K10_TEMPS 3

struct K10Args {
  const float* rc;   // R coef [W, T, J+1, 3, 3, B]
  const float* re;
  const float* rr;
  const float* qc;   // qd coef [W, T, F, B]
  const float* qe;
  const float* qr;
  const float* ac;   // qda
  const float* ae;
  const float* ar;
  const float* dc;   // qdda
  const float* de;
  const float* dr;
  const float* zero; // B + E + 1 zeros: qd, qda, qdda of a joint past F
  float* uc;         // u coef [W, P, T, F, B]
  float* ue;
  float* ur;
  float* wfc;        // wrench f coef [W, P, T, 3, B] (wj >= 0)
  float* wfe;
  float* wfr;
  float* wnc;        // wrench n
  float* wne;
  float* wnr;
  float* fn;         // scratch: F_i, N_i [grid, NG, J, P, 2, 3, ld] of each resident group
  long long n;       // elements, W T
  int T, J, F, P;
  int wj;            // the wrench's joint, or -1
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

// the robot's constants in shared memory, floats (a multiple of 4)
#define K10_CONST ((3 * (K10_MAXJ + 1) + 3 * K10_MAXJ + 18 * K10_MAXJ * K10_MAXP + 3) / 4 * 4)

// floats of one group's shared memory: compact R, mass scratch, entries;
// a multiple of 4, so that every group's R stays 16-byte aligned
static __host__ __device__ __forceinline__ int k10_group_floats(int ld, int ldl) {
  return (9 * ldl + 4 * PZ_MAXMASS + (3 * K10_SLOTS + 3 * K10_TEMPS) * ld + 3) / 4 * 4;
}

static __host__ __device__ __forceinline__ size_t k10_smem(int ld, int ldl, int NG) {
  return PZ_TAB_BYTES + sizeof(float) * (K10_CONST + (size_t)NG * k10_group_floats(ld, ldl));
}

// up to 128 threads a block, three blocks an SM (four warps of one element
// each); one element of 256 threads at the fewest elements
template <int G>
__global__ void __launch_bounds__(G > 128 ? G : 128, G > 128 ? 1 : 3)
    k10_kernel(const K10Args args) {
  extern __shared__ float4 k10_smem_f4[];
  unsigned char* tab = (unsigned char*)k10_smem_f4;
  float* trans = (float*)(tab + PZ_TAB_BYTES);   // [J+1, 3]
  float* com = trans + 3 * (K10_MAXJ + 1);       // [J, 3]
  float* Ic = com + 3 * K10_MAXJ;                // [J, P, 9]
  float* Ir = Ic + 9 * K10_MAXJ * K10_MAXP;
  float* groups = trans + K10_CONST;             // 16-byte aligned
  const int J = args.J, P = args.P, T = args.T;
  for (int i = threadIdx.x; i < 3 * (J + 1); i += blockDim.x) trans[i] = args.trans[i / 3][i % 3];
  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x) com[i] = args.com[i / 3][i % 3];
  for (int i = threadIdx.x; i < 9 * J * P; i += blockDim.x) {
    const int j = i / (9 * P), p = (i / 9) % P, q = i % 9;
    Ic[i] = args.Ic[j][p][q];
    Ir[i] = args.Ir[j][p][q];
  }
  pz_tables_init(tab);   // the last block-wide barrier

  const int B = c_pz.B, E = c_pz.E, ld = B + E + 1, ldl = pz_lin_ld(c_pz.nf, E);
  const int gi = threadIdx.x / G, NG = blockDim.x / G;
  float* rl = groups + gi * k10_group_floats(ld, ldl);   // R compact, 9 entries
  const PZGroup g = {(int)threadIdx.x % G, G, 1 + gi};
  PZCtx c;
  pz_ctx(c, tab, rl + 9 * ldl, g);
  float* slots = c.mass + 4 * PZ_MAXMASS;        // 5 column slots of 3 entries
  const PZMat TA = pz_mat(slots + 3 * K10_SLOTS * ld, ld, 0);
  const PZMat TB = pz_mat(TA.p + 3 * ld, ld, 0), TC = pz_mat(TB.p + 3 * ld, ld, 0);
  float* fn = args.fn + ((long long)blockIdx.x * NG + gi) * (J * P * 6) * ld;
  const int rix = B + E;

  for (long long base = (long long)blockIdx.x * NG; base < args.n;
       base += (long long)gridDim.x * NG) {
    const long long e = base + gi;
    if (e >= args.n) break;
    const long long w = e / T, t = e % T;
    // slot of carry column k (k = 4: the spare) in bits 4k..4k+3
    unsigned sl = 0x43210u;
    auto col = [&](int k) { return pz_mat(slots + ((sl >> (4 * k)) & 15u) * 3 * ld, ld, 0); };
    auto swap_spare = [&](int k) {
      const unsigned a = (sl >> (4 * k)) & 15u, b = (sl >> 16) & 15u;
      sl = (sl & ~((15u << (4 * k)) | (15u << 16))) | (b << (4 * k)) | (a << 16);
    };
    // columns 0..ncols-1 <- A (column): their masses in one pass, then a
    // column at a time into the spare slot, which takes the column's place
    auto rotate = [&](const PZLinA& A, int ncols) {
      pz_masses_of(c, 3 * ncols, [&](int k) { return col(k / 3).p + (k % 3) * ld; });
      for (int k = 0; k < ncols; ++k) {
        pz_matmul_linear_t(c, A, col(k), c.mass + 12 * k, col(4), 3, 3, 1, args.slop);
        swap_spare(k);
      }
    };
    auto force = [&](int i, int p, int which) {
      return pz_mat(fn + ((i * P + p) * 2 + which) * 3 * ld, ld, 0);
    };
    // kinematic carry, columns (wdot | w | w_aux | lin_acc); lin_acc = gravity e_z
    for (int it = g.rank; it < 12 * ld; it += G) slots[it] = it == 11 * ld ? args.gravity : 0.0f;
    pz_sync(g);

    // ---- forward recursion ----
    for (int i = 0; i < J; ++i) {
      const float* tr = trans + 3 * i;
      // lin_acc = lin_acc + (wdot x trans_i + w x (w_aux x trans_i))
      pz_cross_pz_const(c, col(2), tr, TA);
      pz_cross(c, col(1), TA, TB, args.slop);
      pz_add_cross_pz_const(c, col(3), col(0), tr, TB, col(3));
      // (wdot | w | w_aux | acc) <- Rt_i (wdot | w | w_aux | acc), a column at a time
      const long long r0 = (e * (J + 1) + i) * 9;
      pz_load_lin(c, rl, 9, args.rc + r0 * B, args.re + r0 * E, args.rr + r0);
      const PZLinA Rt = {rl, ldl, 3 * ldl};
      rotate(Rt, 4);
      const PZMat WD = col(0), WV = col(1), WA = col(2), LA = col(3);
      const int ax = args.ax[i];
      const float sg = args.sgn[i], rv = args.rv[i];
      const float *qdc, *qde, *qdr, *ddc, *dde, *ddr, *adc, *ade, *adr;
      if (i < args.F) {
        const long long q0 = e * args.F + i;
        qdc = args.qc + q0 * B; qde = args.qe + q0 * E; qdr = args.qr + q0;
        ddc = args.dc + q0 * B; dde = args.de + q0 * E; ddr = args.dr + q0;
        adc = args.ac + q0 * B; ade = args.ae + q0 * E; adr = args.ar + q0;
      } else {
        qdc = ddc = adc = args.zero;
        qde = dde = ade = args.zero + B;
        qdr = ddr = adr = args.zero + B + E;
      }
      // w += e qd ; wdot += w_aux x (e qd) + e qdda ; w_aux += e qda
      pz_zero(c, TB, 3);
      pz_add_scaled_axis(c, TB, ax, sg, rv, qdc, qde, qdr);
      pz_add(c, WV, TB, WV, 3, 1);
      pz_cross(c, WA, TB, TA, args.slop);
      pz_add(c, WD, TA, WD, 3, 1);
      pz_add_scaled_axis(c, WD, ax, sg, rv, ddc, dde, ddr);
      pz_add_scaled_axis(c, WA, ax, sg, rv, adc, ade, adr);
      // f_arg = lin_acc + (wdot x com_i + w x (w_aux x com_i)) -> TA
      const float* cm = com + 3 * i;
      pz_cross_pz_const(c, WA, cm, TA);
      pz_cross(c, WV, TA, TB, args.slop);
      pz_add_cross_pz_const(c, LA, WD, cm, TB, TA);
      for (int p = 0; p < P; ++p) {
        const float* ic = Ic + 9 * (i * P + p);
        const float* ir = Ir + 9 * (i * P + p);
        // F and N are formed in shared memory and only written to the scratch
        pz_mul_interval(c, args.mc[i][p], args.mr[i][p], TA, TC, 3, args.slop);
        pz_copy(c, TC, force(i, p, 0), 3);
        // N = I wdot + w_aux x (I w), the product a column at a time
        pz_matmul_interval(c, ic, ir, WV, TB, 3, 3, 1, args.slop);
        pz_cross(c, WA, TB, TC, args.slop);
        pz_matmul_interval(c, ic, ir, WD, TB, 3, 3, 1, args.slop);
        pz_add(c, TB, TC, force(i, p, 1), 3, 1);
      }
    }

    // ---- backward recursion, last joint first; carry columns (f_p | n_p) ----
    for (int k = 0; k < 4; ++k)
      for (int x = g.rank; x < 3 * ld; x += G) col(k).p[x] = 0.0f;
    pz_sync(g);
    for (int i = J - 1; i >= 0; --i) {
      const long long r0 = (e * (J + 1) + i + 1) * 9;
      pz_load_lin(c, rl, 9, args.rc + r0 * B, args.re + r0 * E, args.rr + r0);
      const PZLinA Rm = {rl, 3 * ldl, ldl};
      rotate(Rm, 2 * P);
      // the torque of a joint past F is not written
      const bool act = i < args.F, wrench = i == args.wj;
      const long long q0 = act ? e * args.F + i : 0;
      const float* qdc = args.qc + q0 * B;
      const float* qde = args.qe + q0 * E;
      const float* ddc = args.dc + q0 * B;
      const float* dde = args.de + q0 * E;
      const float qdr = act ? args.qr[q0] : 0.0f, ddr = act ? args.dr[q0] : 0.0f;
      const int ax = args.ax[i];
      const float sg = args.sgn[i];
      const float sa = args.arm[i] * args.rv[i], sd = args.damp[i] * args.rv[i];
      const float* cm = com + 3 * i;
      const float* tr = trans + 3 * (i + 1);
      for (int p = 0; p < P; ++p) {
        // n = (N_i + rn) + (com_i x F_i + trans_{i+1} x rf) ; f = rf + F_i ;
        // u_i = (sgn n[ax] + arm rv qdda_i) + damp rv qd_i: one pass over x
        const PZMat RF = col(2 * p), RN = col(2 * p + 1);
        const PZMat Fp = force(i, p, 0), Np = force(i, p, 1);
        const long long u0 = ((w * P + p) * T + t) * args.F + i;
        const long long w0 = ((w * P + p) * T + t) * 3;
        for (int x = g.rank; x < ld; x += G) {
          float nn[3], ff[3];
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            const int u = pz_u(o), v = pz_v(o);
            const float ta = pz_cc_at(cm, pz_at(Fp, u, 0), pz_at(Fp, v, 0), o, x, rix);
            const float tb = pz_cc_at(tr, pz_at(RF, u, 0), pz_at(RF, v, 0), o, x, rix);
            nn[o] = (pz_at(Np, o, 0)[x] + pz_at(RN, o, 0)[x]) + (ta + tb);
            ff[o] = pz_at(RF, o, 0)[x] + pz_at(Fp, o, 0)[x];
          }
#pragma unroll
          for (int o = 0; o < 3; ++o) {
            pz_at(RN, o, 0)[x] = nn[o];
            pz_at(RF, o, 0)[x] = ff[o];
          }
          const float na = nn[ax];
          if (wrench) {
#pragma unroll
            for (int o = 0; o < 3; ++o) {
              if (x < B) {
                args.wfc[(w0 + o) * B + x] = ff[o];
                args.wnc[(w0 + o) * B + x] = nn[o];
              } else if (x < rix) {
                args.wfe[(w0 + o) * E + x - B] = ff[o];
                args.wne[(w0 + o) * E + x - B] = nn[o];
              } else {
                args.wfr[w0 + o] = ff[o];
                args.wnr[w0 + o] = nn[o];
              }
            }
          }
          if (!act) continue;
          if (x < B) {
            args.uc[u0 * B + x] = (sg * na + ddc[x] * sa) + qdc[x] * sd;
          } else if (x < rix) {
            args.ue[u0 * E + x - B] = (sg * na + dde[x - B] * sa) + qde[x - B] * sd;
          } else {
            args.ur[u0] = (fabsf(sg) * na + ddr * fabsf(sa)) + qdr * fabsf(sd);
          }
        }
        pz_sync(g);
      }
    }
  }
}

extern "C" int k10_tables(const PZTables* t) { return pz_upload_tables(t); }

// G threads per element (32, 64, 128 or 256), NG elements per block, grid blocks
// walking the n elements; args->fn holds grid * NG * J * P * 6 entries.
extern "C" int k10_launch(const K10Args* args, int ld, int ldl, int G, int NG, int grid,
                          void* stream) {
  const size_t smem = k10_smem(ld, ldl, NG);
  const int threads = G * NG;
  if (threads > 256 || NG > 15) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (G) {
    case 32:
      err = cudaFuncSetAttribute(k10_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      k10_kernel<32><<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(*args);
      break;
    case 64:
      err = cudaFuncSetAttribute(k10_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      k10_kernel<64><<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(*args);
      break;
    case 128:
      err = cudaFuncSetAttribute(k10_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      k10_kernel<128><<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(*args);
      break;
    case 256:
      err = cudaFuncSetAttribute(k10_kernel<256>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      k10_kernel<256><<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(*args);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
