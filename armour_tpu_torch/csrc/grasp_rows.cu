// K16: the grasp rows (waiter's-tray contact constraints) from the RNEA's
// interval contact wrench, in one launch.
//
// Replaces the XLA-fused ops of armour_tpu/grasp.py:131-140 (grasp_frs
// after the RNEA): the pair-table bilinear product of
// armour_tpu/pz/bpz.py:120 in its elementwise form bpz.mul (:170) for the
// five squares mul(p, p) of grasp.py:74-101, the rows' sums and scales
// (bpz.add, scale, neg) and bpz.reduce_.  Plain version:
// grasp.grasp_rows_plain (with pz/bpz.py:_mul).  Per (world, time step),
// from the interval set of K10's wrench f, n [W, P, T, 3]:
//
//   squares  p_c * p_c for c = f_t0, f_t1, f_n, n_t0, n_t1 (the two
//            tangential axes and the normal axis of the payload frame), the
//            bilinear product with independent operands (no x^2 >= 0
//            tightening): pz_mul of pz_ops.cuh, the slop included
//   rows     sep = -f_n;  slip = (f_t0^2 + f_t1^2) + s_mu f_n^2;
//            tip = (n_t0^2 + n_t1^2) + s_r f_n^2  (s_mu = -mu^2, s_r = -r^2,
//            Python doubles rounded once to float32)
//   reduce   g_coef [W, T, 3, B] = the rows' coefficients,
//            g_rad [W, T, 3] = rad + sum |egen|.
//
// Every sum runs in one fixed order that the plain version repeats: a
// coefficient over its monomial's pairs in pair-table order
// (basis.pair_segments); the in-table magnitudes per monomial, then over
// the monomials, and every abs sum, by one warp in pz_ops.cuh's order (lane
// l sums the terms l, l + 32, ..., then a shuffle butterfly:
// utils.warp_sum_in_order); the radius' terms as written.  So K16 gives its
// plain version's bits, and repeated calls the same bits.  Built without
// fast math and with -fmad=false: no contraction into fused multiply-adds.
//
// Bound on the H100 (the dumbbell, W = 64, T = 128, B = 120, E = 38): it
// must read the five components it uses (5 x 159 floats) and write the
// three rows (3 x 121 floats) of each (world, time step), 37.9 MB, 0.0113
// ms at 3.35 TB/s; its ~26 k float32 operations an element (five 680-pair
// tables, the abs sums; chip_smoke.py:k16_work), 0.214 G a call, 0.0032 ms
// at 67 TFLOP/s (0.0064 ms at the 33.5 T/s of separate multiplies and
// adds): bound by bytes.
//
// Design, as K2's: a warp per (world, time step), K16_NG warps a block
// with no barrier between them after the tables, and a persistent grid of
// as many blocks as stay resident (kernels/grasp.py:k16_geometry) that
// walks the elements.  The basis tables come from constant memory
// (uploaded once per library, kernels/pz.py:upload_tables) into shared
// memory once a block.  A warp loads its five operands with pz_load (all
// its values in flight together), forms the five squares with pz_mul (all
// 32 lanes on each square's pair segments and masses), the three rows
// elementwise into the operands' slots (sep in place of f_n, slip and tip
// in place of f_t0 and f_t1, which the rows no longer read), their
// masses, and writes g_coef and g_rad.
#include <cuda_runtime.h>

#include "pz_ops.cuh"

#define K16_NG 4           // warps a block
#define K16_THREADS 128    // 32 K16_NG
#define K16_BLOCKS_PER_SM 8  // __launch_bounds__: at most 64 registers a thread
#define K16_SQ 5           // squares: f_t0, f_t1, f_n, n_t0, n_t1

struct K16Args {
  const float* fc;     // wrench f coef [W, P, T, 3, B]
  const float* fe;     // [W, P, T, 3, E]
  const float* fr;     // [W, P, T, 3]
  const float* nc;     // wrench n
  const float* ne;
  const float* nr;
  float* g_coef;       // [W, T, 3, B]
  float* g_rad;        // [W, T, 3]
  int W, T, P, pset;
  int normal;          // the contact normal's axis in the payload frame
  float s_mu, s_r;     // -mu^2, -r^2
  float slop;
};

// floats of one warp's shared memory: the mass scratch, then the packed
// operands (5, then the rows) and squares (5); a multiple of 4
static __host__ __device__ __forceinline__ int k16_group_floats(int ld) {
  return (4 * PZ_MAXMASS + 2 * K16_SQ * ld + 3) / 4 * 4;
}

static __host__ __device__ __forceinline__ size_t k16_smem(int ld) {
  return PZ_TAB_BYTES + sizeof(float) * (size_t)K16_NG * k16_group_floats(ld);
}

// the operand slot that row r (sep, slip, tip) takes: f_n's, f_t0's, f_t1's
__device__ __forceinline__ int k16_row_slot(int r) { return r == 0 ? 2 : r - 1; }

__global__ void __launch_bounds__(K16_THREADS, K16_BLOCKS_PER_SM)
    k16_kernel(const __grid_constant__ K16Args a, long long n) {
  extern __shared__ float4 k16_smem_f4[];
  unsigned char* tab = (unsigned char*)k16_smem_f4;
  float* groups = (float*)(tab + PZ_TAB_BYTES);
  pz_tables_init(tab);   // the only block-wide barrier

  const int ld = c_pz.B + c_pz.E + 1, gi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const PZGroup g = {lane, 32, 0};
  PZCtx c;
  pz_ctx(c, tab, groups + gi * k16_group_floats(ld), g);
  const int B = c.B, E = c.E, rix = B + E;
  float* x = c.mass + 4 * PZ_MAXMASS;   // [5][ld] operands, then the rows
  float* sq = x + K16_SQ * ld;          // [5][ld] squares
  const int nrm = a.normal, t0 = nrm == 0 ? 1 : 0, t1 = nrm == 2 ? 1 : 2;

  for (long long wt = (long long)blockIdx.x * K16_NG + gi; wt < n;
       wt += (long long)gridDim.x * K16_NG) {   // wt = w T + t
    const long long w = wt / a.T, t = wt - w * a.T;
    // operands: 0, 1 the tangential axes of f, 2 its normal axis, 3, 4 the
    // tangential axes of n
    const long long base = ((w * a.P + a.pset) * a.T + t) * 3;
    pz_load(c, x, K16_SQ, [&](int k) {
      const long long e = base + (k == 2 ? nrm : ((k == 0 || k == 3) ? t0 : t1));
      const PZSrc s = k < 3 ? PZSrc{a.fc + e * B, a.fe + e * E, a.fr + e}
                            : PZSrc{a.nc + e * B, a.ne + e * E, a.nr + e};
      return s;
    });
    pz_sync(g);
    pz_mul(c, pz_mat(x, ld, 0), pz_mat(x, ld, 0), pz_mat(sq, ld, 0), K16_SQ, a.slop);

    // the rows: sep = -f_n; slip, tip = (sq_a + sq_b) + s sq_2, the radius
    // scaled by |s| (bpz.neg, add, scale)
    pz_each(c, 3, [&](int r, int i) {
      float* out = x + k16_row_slot(r) * ld;
      if (r == 0) {
        if (i != rix) out[i] = -out[i];
      } else {
        const float* p = sq + (r == 1 ? 0 : 3) * ld;
        const float s = r == 1 ? a.s_mu : a.s_r;
        out[i] = (p[i] + p[ld + i]) + sq[2 * ld + i] * (i == rix ? fabsf(s) : s);
      }
    });
    pz_sync(g);
    pz_masses_of(c, 3, [&](int k) { return x + k16_row_slot(k) * ld; });

    float* gc = a.g_coef + wt * 3 * B;
    for (int i = lane; i < 3 * B; i += 32) {
      const int r = i / B;
      gc[i] = x[k16_row_slot(r) * ld + i - r * B];
    }
    if (lane < 3)
      a.g_rad[wt * 3 + lane] = x[k16_row_slot(lane) * ld + rix] + c.mass[4 * lane + 1];
    __syncwarp();   // the next element's loads overwrite x only after these reads
  }
}

extern "C" int k16_tables(const PZTables* t) { return pz_upload_tables(t); }

// W T elements over a persistent grid of `grid` blocks of K16_NG warps;
// the basis tables uploaded (k16_tables)
extern "C" int k16_launch(const K16Args* args, int ld, int grid, void* stream) {
  if (args->normal < 0 || args->normal > 2 || args->pset < 0 || args->pset >= args->P ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k16_smem(ld);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long n = (long long)args->W * args->T;
  k16_kernel<<<(unsigned int)grid, K16_THREADS, smem, (cudaStream_t)stream>>>(*args, n);
  return (int)cudaGetLastError();
}
