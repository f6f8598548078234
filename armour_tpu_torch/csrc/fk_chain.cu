// K9: the PZ forward-kinematics chain, all joints in one kernel.
//
// Replaces the scan body of armour_tpu/kinematics.py:97-107 (with
// bpz.matvec_cvec, bpz.matmul_linear_right, bpz.matvec_const_coef
// (armour_tpu/pz/bpz.py:303) and bpz.add): for every (world, time) element
//
//   fk_t <- fk_t + fk_r trans_i ;  fk_r <- fk_r R_i ;
//   link_i = fk_r box_i + fk_t           for i = 0 .. J-1
//
// and writes the link PZs [W, T, J, 3] (coef, egen, rad).  reduce_links
// (kinematics.py:115-125) is not fused: it stays in torch on the links,
// so the plain reference is kinematics.forward_occupancy_plain.
//
// R_i is read in full (all B coefficients, as the plain
// matmul_linear_right_plain reads it): only coefficient 0 and the linear
// ones enter the product through the shift table, all of them enter R_i's
// abs mass.  The JRS writes R of degree <= 1 (jrs.assemble_rotations), the
// condition under which the product is exact.
//
// Bound on the H100 (flagship, W = 64, T = 128, B = 120, E = 38, J = 7):
// each element reads its 63 rotation entries (40 KB) and writes 21 link
// entries (13.4 KB): ~0.44 GB per call, ~0.13 ms at 3.35 TB/s; the
// ~0.4 MFLOP per element (3.3 GFLOP per call) take ~0.05 ms at 67 TFLOP/s,
// so the bound is the bytes.
//
// Design: one block per element, 256 threads.  The carry fk_r [3, 3] and
// fk_t [3] stays in shared memory across the joints as packed PZ entries
// (ld = B + E + 1 floats each, two fk_r buffers), ~25 KB of shared memory
// in all at the flagship widths; every product is a pz_ops.cuh op (the code
// of K1), its abs masses taken a warp per entry in a fixed order.  R_i and the
// link box are staged per joint, the links written per joint.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"

#define K9_THREADS 256
#define K9_MAXJ 8

struct K9Args {
  const float* rc;   // R coef [W, T, Jr, 3, 3, B]
  const float* re;   // R egen [W, T, Jr, 3, 3, E]
  const float* rr;   // R rad  [W, T, Jr, 3, 3]
  const float* bc;   // link boxes coef [J, 3, B]
  const float* be;   // link boxes egen [J, 3, E]
  const float* br;   // link boxes rad  [J, 3]
  float* lc;         // links coef [W, T, J, 3, B]
  float* le;         // links egen [W, T, J, 3, E]
  float* lr;         // links rad  [W, T, J, 3]
  int J, Jr;         // joints in the chain, rotations per element in R
  float slop;
  float trans[K9_MAXJ + 1][3];
};

__global__ void __launch_bounds__(K9_THREADS) k9_kernel(const K9Args args) {
  extern __shared__ float4 k9_smem[];
  unsigned char* tab = (unsigned char*)k9_smem;
  float* mass = (float*)(tab + PZ_TAB_BYTES);
  float* trans = mass + 4 * PZ_MAXMASS;          // [J, 3]
  float* ent = trans + 3 * K9_MAXJ;
  PZCtx c;
  pz_ctx_init(c, tab, mass);
  const int B = c.B, E = c.E, ld = c.ld, J = args.J;
  float* fr0 = ent;               // fk_r, two buffers of 9 entries
  float* ft = fr0 + 18 * ld;      // fk_t, 3
  float* rm = ft + 3 * ld;        // R_i, 9
  float* tt = rm + 9 * ld;        // fk_r trans_i, 3
  float* bx = tt + 3 * ld;        // link box i, 3
  float* lk = bx + 3 * ld;        // link i, 3
  const long long e = blockIdx.x;

  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x) trans[i] = args.trans[i / 3][i % 3];
  for (int i = threadIdx.x; i < 12 * ld; i += blockDim.x) {
    const int k = i / ld, x = i % ld;
    // fk_r = I (coefficient 0 of the diagonal), fk_t = 0
    fr0[i] = (k < 9 && x == 0 && (k / 3) == (k % 3)) ? 1.0f : 0.0f;
    if (k >= 9) ft[i - 9 * ld] = 0.0f;
  }
  __syncthreads();

  int cur = 0;
  const PZMat FTv = pz_mat(ft, ld, 0), TTv = pz_mat(tt, ld, 0), LKv = pz_mat(lk, ld, 0);
  const PZMat RMv = pz_mat(rm, 3 * ld, ld), BXv = pz_mat(bx, ld, 0);
  for (int i = 0; i < J; ++i) {
    const PZMat FR = pz_mat(fr0 + cur * 9 * ld, 3 * ld, ld);
    const PZMat FRn = pz_mat(fr0 + (1 - cur) * 9 * ld, 3 * ld, ld);
    pz_matvec_cvec(c, FR, trans + 3 * i, TTv, 3, 3);
    pz_add(c, FTv, TTv, FTv, 3, 1);
    const long long r0 = (e * args.Jr + i) * 9;
    pz_load(c, rm, 9, args.rc + r0 * B, args.re + r0 * E, args.rr + r0);
    pz_load(c, bx, 3, args.bc + (long long)i * 3 * B, args.be + (long long)i * 3 * E,
            args.br + i * 3);
    __syncthreads();
    // fk_r R_i = (R_i^T fk_r^T)^T: the transposes are views
    pz_matmul_linear(c, pz_t(RMv), pz_t(FR), pz_t(FRn), 3, 3, 3, args.slop);
    cur = 1 - cur;
    pz_matvec_const_coef(c, FRn, BXv, LKv, 3, 3, args.slop);
    pz_add(c, LKv, FTv, LKv, 3, 1);
    const long long l0 = (e * J + i) * 3;
    pz_store(c, LKv, 3, args.lc + l0 * B, args.le + l0 * E, args.lr + l0);
    __syncthreads();
  }
}

extern "C" int k9_tables(const PZTables* t) { return pz_upload_tables(t); }

extern "C" int k9_launch(const K9Args* args, long long blocks, int ld, void* stream) {
  const size_t smem = PZ_TAB_BYTES
      + sizeof(float) * (4 * PZ_MAXMASS + 3 * K9_MAXJ + 39 * ld);
  cudaError_t err = cudaFuncSetAttribute(k9_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  k9_kernel<<<(unsigned int)blocks, K9_THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
