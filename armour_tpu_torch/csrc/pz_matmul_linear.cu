// K1: product of a degree<=1 rotation PZ matrix with a PZ matrix.
//
// Replaces armour_tpu/pz/bpz.py:214-285 (matmul_linear) and, through
// transposed strides, bpz.py:294-300 (matmul_linear_right).  Since the FK
// and RNEA chains became kernels K9 / K10, the planning step no longer
// calls it; it serves the op-level route of the PZ RNEA with an uncertain
// centre of mass (dynamics.rnea_pz_sets), which K10 does not take: 14 calls
// a W = 64 planning step of the Kinova with com_uncertainty = 0.05, the
// forward rotation (3x3 @ 3x4 over 8,192 elements) and the backward one
// (3x3 @ 3x2 over 16,384, a broadcast over the parameter sets by a stride
// of 0).
//
//   out[i,k] = sum_j a[i,j] (x) b[j,k]      a: [.., n, m], b: [.., m, p]
//
// with a's k-coefficients of degree <= 1, so a coefficient of out at
// monomial mono(x) only needs b's coefficient at mono(x)/k_f, read through
// the [nf, B] shift table.  Error generators take the linear cross terms,
// everything else is outward-rounded into rad exactly as the JAX code
// writes it, plus the relative float_slop.
//
// Bound on the H100 (flagship, per call, W = 64, T = 128, B = 120, E = 38):
// every operand and the result are ~5.7 KB per (world, time) element,
// 47-63 MB per operand, so one call moves 140-170 MB: ~42-51 us at
// 3.35 TB/s.  The arithmetic (~52 kflop per element) is under 10 us at the
// 67 TFLOP/s float32 rate, so the kernel is bound by bytes.
//
// Design, as K2's: a group of G threads per element (one warp at the
// flagship sizes), NG elements a block, and a persistent grid of as many
// blocks as stay resident (two an SM under the launch bounds below: 128
// registers a thread, no spills) that walks the elements
// (kernels/pz.py:k1_geometry).  The basis tables are staged in shared
// memory once a block.  Per element, a comes in once, compact, through
// pz_load_lin (coefficient 0, the linear ones, the error generators, the
// radius and its masses over every coefficient: the same bits as the
// packed entry); then the result is formed a column at a time: b's column
// kk through pz_load (its m values of a warp in flight at once) and its
// masses through pz_masses_of, pz_matmul_linear_t of pz_ops.cuh (which K9
// and K10 run as well) into shared memory, and pz_each writes the column
// through the output's strides, so a transposed result (matmul_linear_right)
// is a view.  Both operands are read through strided views (a transposed
// operand, or a broadcast over parameter sets, is a stride).  A column at
// a time keeps an element's shared memory at ~6 KB (a, one column of b and
// of the result), so eight elements a block fit at every shape; the whole
// b and result of the forward 3x4 product (~18 KB an element) allowed six,
// and on an H100 the column form took 0.27 / 0.29 / 0.21 ms against 0.39 /
// 0.33 / 0.24 on the three shapes (the same bits; 80 or 64 registers and a
// third or fourth block an SM spilled and were slower).  Every op ends with
// the group's barrier (__syncwarp, or a named barrier), so no element
// waits for another, and pz_ops.cuh gives the same bits whatever the
// group's size: the result does not depend on the geometry.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"
#include "pz_view.cuh"

#define K1_THREADS 256     // threads of a block of several elements at most

struct K1Args {
  PZView a, b, out;
  int bd[3];
  int n, m, p;
  float slop;
};

// floats of one group's shared memory: the mass scratch, a's n m compact
// entries (16-byte aligned), then the packed entries of one column of b (m)
// and of the result (n); a multiple of 4
static __host__ __device__ __forceinline__ int k1_group_floats(int ld, int ldl, int n, int m) {
  return (4 * PZ_MAXMASS + n * m * ldl + (m + n) * ld + 3) / 4 * 4;
}

static __host__ __device__ __forceinline__ size_t k1_smem(int ld, int ldl, int n, int m, int NG) {
  return PZ_TAB_BYTES + sizeof(float) * (size_t)NG * k1_group_floats(ld, ldl, n, m);
}

__global__ void __launch_bounds__(K1_THREADS, 2) k1_kernel(const K1Args args, long long total,
                                                           int G) {
  extern __shared__ float4 k1_smem_f4[];
  unsigned char* tab = (unsigned char*)k1_smem_f4;
  float* groups = (float*)(tab + PZ_TAB_BYTES);
  pz_tables_init(tab);   // the only block-wide barrier

  const int n = args.n, m = args.m, p = args.p;
  const int ld = c_pz.B + c_pz.E + 1, ldl = pz_lin_ld(c_pz.nf, c_pz.E);
  const int gi = threadIdx.x / G, NG = blockDim.x / G;
  const PZGroup g = {(int)threadIdx.x - gi * G, G, 1 + gi};
  PZCtx c;
  pz_ctx(c, tab, groups + gi * k1_group_floats(ld, ldl, n, m), g);
  float* sa = c.mass + 4 * PZ_MAXMASS;
  float* sb = sa + n * m * ldl;
  float* so = sb + m * ld;
  const int B = c.B, E = c.E;
  const PZLinA A = {sa, m * ldl, ldl};

  for (long long base = (long long)blockIdx.x * NG; base < total;
       base += (long long)gridDim.x * NG) {
    const long long e = base + gi;
    if (e >= total) break;
    long long ix[3];
    pz_batch_index(e, args.bd, ix);
    pz_load_lin(c, sa, n * m, pz_view_src(args.a, ix, m));
    const PZViewSrc bsrc = pz_view_src(args.b, ix, p);
    float* oc = args.out.coef + pz_off(args.out.cb, ix);
    float* oe = args.out.egen + pz_off(args.out.eb, ix);
    float* orad = args.out.rad + pz_off(args.out.rb, ix);
    for (int kk = 0; kk < p; ++kk) {
      pz_load(c, sb, m, [&](int j) { return bsrc(j * p + kk); });
      pz_sync(g);
      pz_masses_of(c, m, [&](int k) { return sb + k * ld; });
      pz_matmul_linear_t(c, A, pz_mat(sb, ld, 0), c.mass, pz_mat(so, ld, 0), n, m, 1,
                         args.slop);
      pz_each(c, n, [&](int i, int x) {
        const float v = so[i * ld + x];
        if (x < B) oc[i * args.out.cv[0] + kk * args.out.cv[1] + x] = v;
        else if (x < B + E) oe[i * args.out.ev[0] + kk * args.out.ev[1] + x - B] = v;
        else orad[i * args.out.rv[0] + kk * args.out.rv[1]] = v;
      });
    }
  }
}

extern "C" int k1_tables(const PZTables* t) { return pz_upload_tables(t); }

// total elements; ld / ldl the packed / compact entry widths; G threads per
// element (a multiple of 32), NG elements per block, grid blocks walking the
// elements.
extern "C" int k1_launch(const K1Args* args, long long total, int ld, int ldl, int G, int NG,
                         int grid, void* stream) {
  if (G < 32 || G % 32 != 0 || NG < 1 || NG > 15 || G * NG > K1_THREADS || args->n < 1
      || args->n > PZ_MAXM || args->m < 1 || args->m > PZ_MAXM || args->p < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k1_smem(ld, ldl, args->n, args->m, NG);
  cudaError_t err = cudaFuncSetAttribute(k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  k1_kernel<<<(unsigned int)grid, G * NG, smem, (cudaStream_t)stream>>>(*args, total, G);
  return (int)cudaGetLastError();
}
