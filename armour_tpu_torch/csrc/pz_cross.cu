// K2: PZ x PZ 3-vector cross product.
//
// Replaces armour_tpu/pz/bpz.py:120-167 (bilinear) as used by cross
// (bpz.py:481-484).  Since the RNEA chain became kernel K10, the planning
// step no longer calls it; it serves the op-level route of the PZ RNEA with
// an uncertain centre of mass, which K10 does not take: 49 calls a W = 64
// planning step of the Kinova with com_uncertainty = 0.05 (seven a joint),
// over 8,192 or 16,384 elements each.  The JAX code gathers both coefficient
// vectors through the 680-entry pair table, multiplies, and scatters into
// the B = 120 monomials with a one-hot [680, 120] matmul.
//
// Here the pair table is sorted by output monomial once on the host
// (pz/basis.py:pair_segments), so each output monomial is a fixed segment
// that one lane sums in table order: a static segment sum, no atomics, a
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
// On an H100 it runs at 4.8-6x that bound; no launch geometry, register
// cap or narrower pair index moved it, which points at the pair loop's
// shared-memory loads (six operand values and two table bytes a pair, at
// data-dependent addresses).
//
// Design, as K10's: a group of G threads per element (one warp at the
// flagship sizes: it takes all three components, each pair's six operand
// values read once; three warps or more take a component each), NG elements
// a block, and a persistent grid of as many blocks as stay resident (two an
// SM under the launch bounds below) that walks the elements
// (kernels/pz.py:k2_geometry).  The basis tables are staged in shared memory
// once a block; every op ends with the group's barrier (__syncwarp, or a
// named barrier), so no element waits for another.  Each element's six
// operand entries come in through pz_load (all of a warp's values in flight
// at once), read through strided views: broadcasting over the parameter-set
// axis is a stride of 0.  pz_ops.cuh gives the same bits whatever the
// group's size, so the result does not depend on the geometry.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"
#include "pz_view.cuh"

#define K2_THREADS 256     // threads of a block of several elements at most

struct K2Args {
  PZView a, b, out;
  int bd[3];
  float slop;
};

// floats of one group's shared memory: the mass scratch, then the packed
// entries of a, b and the result (3 each); a multiple of 4
static __host__ __device__ __forceinline__ int k2_group_floats(int ld) {
  return (4 * PZ_MAXMASS + 9 * ld + 3) / 4 * 4;
}

static __host__ __device__ __forceinline__ size_t k2_smem(int ld, int NG) {
  return PZ_TAB_BYTES + sizeof(float) * (size_t)NG * k2_group_floats(ld);
}

__global__ void __launch_bounds__(K2_THREADS, 2) k2_kernel(const K2Args args, long long n, int G) {
  extern __shared__ float4 k2_smem_f4[];
  unsigned char* tab = (unsigned char*)k2_smem_f4;
  float* groups = (float*)(tab + PZ_TAB_BYTES);
  pz_tables_init(tab);   // the only block-wide barrier

  const int ld = c_pz.B + c_pz.E + 1;
  const int gi = threadIdx.x / G, NG = blockDim.x / G;
  const PZGroup g = {(int)threadIdx.x - gi * G, G, 1 + gi};
  PZCtx c;
  pz_ctx(c, tab, groups + gi * k2_group_floats(ld), g);
  float* sa = c.mass + 4 * PZ_MAXMASS;
  float* sb = sa + 3 * ld;
  float* so = sb + 3 * ld;
  const int B = c.B, E = c.E;

  for (long long base = (long long)blockIdx.x * NG; base < n; base += (long long)gridDim.x * NG) {
    const long long e = base + gi;
    if (e >= n) break;
    long long ix[3];
    pz_batch_index(e, args.bd, ix);
    pz_load(c, sa, 3, args.a.coef + pz_off(args.a.cb, ix), args.a.cv[0],
            args.a.egen + pz_off(args.a.eb, ix), args.a.ev[0],
            args.a.rad + pz_off(args.a.rb, ix), args.a.rv[0]);
    pz_load(c, sb, 3, args.b.coef + pz_off(args.b.cb, ix), args.b.cv[0],
            args.b.egen + pz_off(args.b.eb, ix), args.b.ev[0],
            args.b.rad + pz_off(args.b.rb, ix), args.b.rv[0]);
    pz_sync(g);

    pz_cross(c, pz_mat(sa, ld, 0), pz_mat(sb, ld, 0), pz_mat(so, ld, 0), args.slop);

    // the next element's loads write only sa and sb, and its first op syncs
    // before anything writes so again
    float* oc = args.out.coef + pz_off(args.out.cb, ix);
    float* oe = args.out.egen + pz_off(args.out.eb, ix);
    float* orad = args.out.rad + pz_off(args.out.rb, ix);
    pz_each(c, 3, [&](int o, int x) {
      const float v = so[o * ld + x];
      if (x < B) oc[o * args.out.cv[0] + x] = v;
      else if (x < B + E) oe[o * args.out.ev[0] + x - B] = v;
      else orad[o * args.out.rv[0]] = v;
    });
  }
}

extern "C" int k2_tables(const PZTables* t) { return pz_upload_tables(t); }

// n elements; G threads per element (a multiple of 32), NG elements per
// block, grid blocks walking the elements.
extern "C" int k2_launch(const K2Args* args, long long n, int ld, int G, int NG, int grid,
                         void* stream) {
  if (G < 32 || G % 32 != 0 || NG < 1 || NG > 15 || G * NG > K2_THREADS)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k2_smem(ld, NG);
  cudaError_t err = cudaFuncSetAttribute(k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  k2_kernel<<<(unsigned int)grid, G * NG, smem, (cudaStream_t)stream>>>(*args, n, G);
  return (int)cudaGetLastError();
}
