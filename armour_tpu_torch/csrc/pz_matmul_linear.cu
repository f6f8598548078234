// K1: product of a degree<=1 rotation PZ matrix with a PZ matrix.
//
// Replaces armour_tpu/pz/bpz.py:214-285 (matmul_linear) and, through
// transposed strides, bpz.py:294-300 (matmul_linear_right).  Since the FK
// and RNEA chains became kernels K9 / K10, the planning step no longer
// calls it; it serves the op-level route of the PZ RNEA with an uncertain
// centre of mass (dynamics.rnea_pz_sets), which K10 does not take.
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
// Design: one block per batch element, 128 threads.  The block stages both
// operands in shared memory as packed PZ entries (coalesced along the
// monomial axis) and runs pz_matmul_linear of pz_ops.cuh, the same code the
// chain kernels run: the abs masses taken a warp per entry in a fixed order,
// the basis tables sit in constant memory and are copied to shared memory
// per block.  Results do not depend on the launch.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"
#include "pz_view.cuh"

#define K1_THREADS 128

struct K1Args {
  PZView a, b, out;
  int bd[3];
  int n, m, p;
  float slop;
};

__global__ void __launch_bounds__(K1_THREADS) k1_kernel(const K1Args args) {
  extern __shared__ float4 k1_smem[];
  unsigned char* tab = (unsigned char*)k1_smem;
  float* mass = (float*)(tab + PZ_TAB_BYTES);
  float* ent = mass + 4 * PZ_MAXMASS;
  PZCtx c;
  pz_ctx_init(c, tab, mass);
  const int n = args.n, m = args.m, p = args.p;
  const int B = c.B, E = c.E, ld = c.ld;
  float* sa = ent;
  float* sb = sa + n * m * ld;
  float* so = sb + m * p * ld;

  long long ix[3];
  pz_batch_index(blockIdx.x, args.bd, ix);
  const float* ac = args.a.coef + pz_off(args.a.cb, ix);
  const float* ae = args.a.egen + pz_off(args.a.eb, ix);
  const float* ar = args.a.rad + pz_off(args.a.rb, ix);
  const float* bc = args.b.coef + pz_off(args.b.cb, ix);
  const float* be = args.b.egen + pz_off(args.b.eb, ix);
  const float* br = args.b.rad + pz_off(args.b.rb, ix);

  for (int it = threadIdx.x; it < n * m * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld, i = k / m, j = k % m;
    sa[it] = x < B ? ac[i * args.a.cv[0] + j * args.a.cv[1] + x]
           : x < B + E ? ae[i * args.a.ev[0] + j * args.a.ev[1] + x - B]
           : ar[i * args.a.rv[0] + j * args.a.rv[1]];
  }
  for (int it = threadIdx.x; it < m * p * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld, j = k / p, q = k % p;
    sb[it] = x < B ? bc[j * args.b.cv[0] + q * args.b.cv[1] + x]
           : x < B + E ? be[j * args.b.ev[0] + q * args.b.ev[1] + x - B]
           : br[j * args.b.rv[0] + q * args.b.rv[1]];
  }
  __syncthreads();

  pz_matmul_linear(c, pz_mat(sa, m * ld, ld), pz_mat(sb, p * ld, ld), pz_mat(so, p * ld, ld),
                   n, m, p, args.slop);

  float* oc = args.out.coef + pz_off(args.out.cb, ix);
  float* oe = args.out.egen + pz_off(args.out.eb, ix);
  float* orad = args.out.rad + pz_off(args.out.rb, ix);
  for (int it = threadIdx.x; it < n * p * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld, i = k / p, q = k % p;
    if (x < B) oc[i * args.out.cv[0] + q * args.out.cv[1] + x] = so[it];
    else if (x < B + E) oe[i * args.out.ev[0] + q * args.out.ev[1] + x - B] = so[it];
    else orad[i * args.out.rv[0] + q * args.out.rv[1]] = so[it];
  }
}

extern "C" int k1_tables(const PZTables* t) { return pz_upload_tables(t); }

extern "C" int k1_launch(const K1Args* args, long long blocks, int ld, void* stream) {
  const int ents = args->n * args->m + args->m * args->p + args->n * args->p;
  const size_t smem = PZ_TAB_BYTES + sizeof(float) * (4 * PZ_MAXMASS + ents * ld);
  k1_kernel<<<(unsigned int)blocks, K1_THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
