// K2: PZ x PZ 3-vector cross product.
//
// Replaces armour_tpu/pz/bpz.py:120-167 (bilinear) as used by cross
// (bpz.py:481-484).  Since the RNEA chain became kernel K10, the planning
// step no longer calls it; it serves the op-level route of the PZ RNEA with
// an uncertain centre of mass (194 calls a plan), which K10 does not take.
// The JAX code gathers both coefficient vectors through the 680-entry pair
// table, multiplies, and scatters into the B = 120 monomials with a one-hot
// [680, 120] matmul.
//
// Here the pair table is sorted by output monomial once on the host
// (pz/basis.py:pair_segments), so each output monomial is a fixed segment
// that one thread sums in table order: a static segment sum, no atomics, a
// result independent of the launch.  The in-basis abs mass |a_i||b_j| is
// taken per pair on the abs operands before any contraction (bpz.py:139),
// reduced in a fixed order, and the overflow is
// max(absprod(Sa, Sb) - in_abs, 0).  Error generators and the radius follow
// bpz.py:146-166 term by term, plus the relative float_slop.  The
// arithmetic is pz_cross of pz_ops.cuh, which K10 runs as well.
//
// Bound on the H100 (flagship, W = 64, T = 128, B = 120, E = 38): each
// operand and the result are ~1.9 KB per (world, [set,] time) element, so a
// call over 8,192-16,384 elements moves 47-78 MB: ~14-23 us at 3.35 TB/s.
// The ~16 kflop per element stays under 5 us at 67 TFLOP/s: bound by bytes.
//
// Design: one block per batch element, 128 threads, both operands staged
// in shared memory as packed PZ entries.  Broadcasting over the
// parameter-set axis is a stride of 0 in the operand view.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"
#include "pz_view.cuh"

#define K2_THREADS 128

struct K2Args {
  PZView a, b, out;
  int bd[3];
  float slop;
};

__global__ void __launch_bounds__(K2_THREADS) k2_kernel(const K2Args args) {
  extern __shared__ float4 k2_smem[];
  unsigned char* tab = (unsigned char*)k2_smem;
  float* mass = (float*)(tab + PZ_TAB_BYTES);
  float* ent = mass + 4 * PZ_MAXMASS;
  PZCtx c;
  pz_ctx_init(c, tab, mass);
  const int B = c.B, E = c.E, ld = c.ld;
  float* sa = ent;
  float* sb = sa + 3 * ld;
  float* so = sb + 3 * ld;

  long long ix[3];
  pz_batch_index(blockIdx.x, args.bd, ix);
  const float* ac = args.a.coef + pz_off(args.a.cb, ix);
  const float* ae = args.a.egen + pz_off(args.a.eb, ix);
  const float* ar = args.a.rad + pz_off(args.a.rb, ix);
  const float* bc = args.b.coef + pz_off(args.b.cb, ix);
  const float* be = args.b.egen + pz_off(args.b.eb, ix);
  const float* br = args.b.rad + pz_off(args.b.rb, ix);

  for (int it = threadIdx.x; it < 3 * ld; it += blockDim.x) {
    const int o = it / ld, x = it % ld;
    sa[it] = x < B ? ac[o * args.a.cv[0] + x] : x < B + E ? ae[o * args.a.ev[0] + x - B]
           : ar[o * args.a.rv[0]];
    sb[it] = x < B ? bc[o * args.b.cv[0] + x] : x < B + E ? be[o * args.b.ev[0] + x - B]
           : br[o * args.b.rv[0]];
  }
  __syncthreads();

  pz_cross(c, pz_mat(sa, ld, 0), pz_mat(sb, ld, 0), pz_mat(so, ld, 0), args.slop);

  float* oc = args.out.coef + pz_off(args.out.cb, ix);
  float* oe = args.out.egen + pz_off(args.out.eb, ix);
  float* orad = args.out.rad + pz_off(args.out.rb, ix);
  for (int it = threadIdx.x; it < 3 * ld; it += blockDim.x) {
    const int o = it / ld, x = it % ld;
    if (x < B) oc[o * args.out.cv[0] + x] = so[it];
    else if (x < B + E) oe[o * args.out.ev[0] + x - B] = so[it];
    else orad[o * args.out.rv[0]] = so[it];
  }
}

extern "C" int k2_tables(const PZTables* t) { return pz_upload_tables(t); }

extern "C" int k2_launch(const K2Args* args, long long blocks, int ld, void* stream) {
  const size_t smem = PZ_TAB_BYTES + sizeof(float) * (4 * PZ_MAXMASS + 9 * ld);
  k2_kernel<<<(unsigned int)blocks, K2_THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
