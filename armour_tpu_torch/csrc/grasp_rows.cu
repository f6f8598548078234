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
//            tightening): pz_mul's arithmetic (pz_ops.cuh), the slop included
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
// Design, from timings of the kernel's parts on an H100 (chip_probe.py
// builds them with K16_ABLATE): a warp an element running pz_ops.cuh's
// pz_mul spends 60% of its time in the squares' shared-memory loads and
// 31% in loads that no work hides, and a warp that copies its own next
// element's ten small ranges still reads at a third of the card's rate.
// So:
//   - a tile is K16_NG consecutive time steps of one world: its wrench
//     entries (f's three components, n's three) are six contiguous ranges
//     (coef, egen, rad of f and of n); a persistent grid of as many blocks
//     as stay resident (kernels/grasp.py:k16_geometry) walks the tiles, and
//     each block copies its next tile with cp.async into a two-stage ring
//     while it works on this one.  Each range lands at the phase (offset
//     mod 4 floats) it has in its tensor, 16-byte chunks between a 4-byte
//     head and tail, so the bases must be 16-byte aligned (the wrapper
//     raises otherwise); n's normal component comes along unused;
//   - a warp takes one step of the tile; its operands' coefficients are
//     laid out again, interleaved [monomial][5] (an odd stride: a warp's
//     operand loads fall on distinct banks as often as one operand's did),
//     while each lane takes their abs masses (sum |coef|, sum |egen|) from
//     the same values;
//   - the pair loop: lane l takes the monomials l, l + 32, ... (their pair
//     ranges held in registers) and per pair loads one packed index of the
//     two operands' byte offsets, then both operands of all five squares:
//     the five coefficient sums and in-table magnitudes run side by side,
//     each in pair-table order;
//   - the rows' coefficients are formed from the squares' in registers and
//     stored; the squares' egen, the slop's and the rows' abs sums come from
//     registers too, then every butterfly at once, and every lane forms the
//     radii (lane 0 stores them).
// pz_mul takes ten mass entries (a's and b's, equal for a square), two
// byte-index loads a pair and square and a barrier between its phases; K16
// runs its sums in the same orders (utils.warp_sum_in_order).
#include <cuda_runtime.h>

#include "pz_ops.cuh"
#include "ring_copy.cuh"

#define K16_NG 8           // warps a block, and time steps a tile
#define K16_THREADS 256    // 32 K16_NG
#define K16_BLOCKS_PER_SM 2  // __launch_bounds__: at most 128 registers a thread
#define K16_STAGES 2
#define K16_SQ 5           // squares: f_t0, f_t1, f_n, n_t0, n_t1
#define K16_SLOTS 4        // monomials a lane takes: PZ_MAXB / 32
#define K16_RANGES 6       // a tile's: coef, egen, rad of f, then of n
// the block's tables: the pairs' packed operand offsets, the segment bounds
#define K16_TAB_BYTES (4 * PZ_MAXPAIRS + 2 * (PZ_MAXB + 8))
// K16_ABLATE: set only by chip_probe.py, which times parts of the kernel
// (1: the loads and the stores; 2: with the five squares); 0 is the kernel
#ifndef K16_ABLATE
#define K16_ABLATE 0
#endif

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

// floats a tile's range holds per wrench entry: coef B, egen E, rad 1
__device__ __forceinline__ int k16_width(int r, int B, int E) {
  const int q = r % 3;
  return q == 0 ? B : q == 1 ? E : 1;
}

// floats of a range's ring slot: a tile's 3 K16_NG entries and 3 floats of
// phase, a multiple of 4
__device__ __forceinline__ int k16_slot(int r, int B, int E) {
  return (3 * K16_NG * k16_width(r, B, E) + 3 + 3) / 4 * 4;
}

// floats of a stage, bounded by ld = B + E + 1 alone (the six slots sum to
// at most 6 K16_NG ld + 32)
static __host__ __device__ __forceinline__ int k16_stage_floats(int ld) {
  return (6 * K16_NG * ld + 36 + 3) / 4 * 4;
}

// bytes of a block: the tables, the ring, each warp's interleaved
// coefficients [PZ_MAXB][5]
static __host__ __device__ __forceinline__ size_t k16_smem(int ld) {
  return K16_TAB_BYTES +
         sizeof(float) * ((size_t)K16_STAGES * k16_stage_floats(ld) + K16_NG * K16_SQ * PZ_MAXB);
}

// The first wrench entry (row of the [W, P, T, 3] wrench) of tile (w, t0).
__device__ __forceinline__ long long k16_entry0(const K16Args& a, int w, int t0) {
  return ((long long)(w * a.P + a.pset) * a.T + t0) * 3;
}

__device__ __forceinline__ const float* k16_base(const K16Args& a, int r) {
  return r == 0 ? a.fc : r == 1 ? a.fe : r == 2 ? a.fr : r == 3 ? a.nc : r == 4 ? a.ne : a.nr;
}

// Start the copies of tile (w, t0) of nv steps into stage st (each range
// at its slot, ring_copy).
__device__ __forceinline__ void k16_issue(const K16Args& a, float* st, int B, int E, int w,
                                          int t0, int nv) {
  const long long e0 = k16_entry0(a, w, t0);
#pragma unroll
  for (int r = 0; r < K16_RANGES; ++r) {
    const int width = k16_width(r, B, E);
    ring_copy(st, k16_base(a, r), e0 * width, 3 * nv * width, K16_THREADS);
    st += k16_slot(r, B, E);
  }
}

__global__ void __launch_bounds__(K16_THREADS, K16_BLOCKS_PER_SM)
    k16_kernel(const __grid_constant__ K16Args a) {
  extern __shared__ __align__(16) float k16_smem_f[];
  unsigned* pk = (unsigned*)k16_smem_f;             // [PZ_MAXPAIRS]
  short* seg = (short*)(pk + PZ_MAXPAIRS);          // [PZ_MAXB + 8]
  const int B = c_pz.B, E = c_pz.E, P = c_pz.P, ld = B + E + 1, T = a.T;
  // pair q: the byte offsets of its operands pi, pj in the interleaved layout
  for (int q = threadIdx.x; q < P; q += K16_THREADS)
    pk[q] = (unsigned)c_pz.pi[q] * (4 * K16_SQ) | ((unsigned)c_pz.pj[q] * (4 * K16_SQ)) << 16;
  for (int i = threadIdx.x; i <= B; i += K16_THREADS) seg[i] = c_pz.seg[i];

  const int gi = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stage = k16_stage_floats(ld);
  float* ring = (float*)((unsigned char*)k16_smem_f + K16_TAB_BYTES);
  float* inter = ring + K16_STAGES * stage + gi * K16_SQ * PZ_MAXB;   // [B][5]
  const int per_world = (T + K16_NG - 1) / K16_NG, tiles = a.W * per_world;
  // the wrench components of operands 0-4: f_t0, f_t1, f_n, n_t0, n_t1
  const int nrm = a.normal, c0 = nrm == 0 ? 1 : 0, c1 = nrm == 2 ? 1 : 2;
  const int comp[K16_SQ] = {c0, c1, nrm, c0, c1};

  int tile = blockIdx.x;
  if (tile < tiles) {
    const int w = tile / per_world, t0 = (tile - w * per_world) * K16_NG;
    k16_issue(a, ring, B, E, w, t0, min(K16_NG, T - t0));
  }
  ring_commit();
  __syncthreads();   // the tables
  int q0[K16_SLOTS], q1[K16_SLOTS];                 // the lane's monomials' pair ranges
#pragma unroll
  for (int t = 0; t < K16_SLOTS; ++t) {
    const int x = lane + 32 * t;
    q0[t] = x < B ? seg[x] : 0;
    q1[t] = x < B ? seg[x + 1] : 0;
  }

  for (int it = 0; tile < tiles; ++it, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      const int w = next / per_world, t0 = (next - w * per_world) * K16_NG;
      k16_issue(a, ring + ((it + 1) % K16_STAGES) * stage, B, E, w, t0, min(K16_NG, T - t0));
    }
    ring_commit();
    ring_wait<K16_STAGES - 1>();
    __syncthreads();

    const int w = tile / per_world, t0 = (tile - w * per_world) * K16_NG, t = t0 + gi;
    if (t < T) {
      // the ranges of this tile in the stage, each at its phase; this
      // warp's entries are the 3 at t
      const long long e0 = k16_entry0(a, w, t0);
      const float* rg[K16_RANGES];
      const float* r0 = ring + (it % K16_STAGES) * stage;
#pragma unroll
      for (int r = 0; r < K16_RANGES; ++r) {
        const int width = k16_width(r, B, E);
        rg[r] = r0 + (int)((e0 * width) & 3) + 3 * gi * width;
        r0 += k16_slot(r, B, E);
      }
      const float* xc[K16_SQ];   // the operands' coef and egen in the stage, and rad
      const float* xe[K16_SQ];
      float xr[K16_SQ];
#pragma unroll
      for (int k = 0; k < K16_SQ; ++k) {
        const int o = k < 3 ? 0 : 3;
        xc[k] = rg[o] + comp[k] * B;
        xe[k] = rg[o + 1] + comp[k] * E;
        xr[k] = rg[o + 2][comp[k]];
      }
      const long long wt = (long long)w * T + t;
      float* gc = a.g_coef + wt * 3 * B;
#if K16_ABLATE == 1
#pragma unroll
      for (int r = 0; r < 3; ++r)
        for (int x = lane; x < B; x += 32) gc[r * B + x] = xc[r][x];
      if (lane < 3) a.g_rad[wt * 3 + lane] = xr[lane] + xe[lane][0];
#else
      // the interleaved coefficients and each operand's abs masses, lane l
      // over the terms l, l + 32, ... (pz_mass_loop's order); the lane keeps
      // its egen values q = l, l + 32
      float S[K16_SQ], Eg[K16_SQ], ev0[K16_SQ], ev1[K16_SQ];
#pragma unroll
      for (int k = 0; k < K16_SQ; ++k) {
        float s = 0.0f;
#pragma unroll
        for (int u = 0; u < K16_SLOTS; ++u) {
          const int b = lane + 32 * u;
          if (b < B) {
            const float v = xc[k][b];
            s += fabsf(v);
            inter[b * K16_SQ + k] = v;
          }
        }
        S[k] = s;
        float e = 0.0f;
        ev0[k] = lane < E ? xe[k][lane] : 0.0f;
        ev1[k] = lane + 32 < E ? xe[k][lane + 32] : 0.0f;
        if (lane < E) e += fabsf(ev0[k]);
        if (lane + 32 < E) e += fabsf(ev1[k]);
        Eg[k] = e;
      }
      __syncwarp();

      // the pair loop: coefficient x of square k is the sum over x's pairs
      // in table order of u v, its in-table magnitude of |u| |v|
      // (pz_mul_coefs); the in-table sums and the coefficients' abs sums
      // gather per lane
      float ia[K16_SQ], So[K16_SQ];
#pragma unroll
      for (int k = 0; k < K16_SQ; ++k) ia[k] = So[k] = 0.0f;
#pragma unroll
      for (int u = 0; u < K16_SLOTS; ++u) {
        const int x = lane + 32 * u;
        if (x < B) {
          float sc[K16_SQ], im[K16_SQ];
#pragma unroll
          for (int k = 0; k < K16_SQ; ++k) sc[k] = im[k] = 0.0f;
#pragma unroll 2
          for (int q = q0[u]; q < q1[u]; ++q) {
            const unsigned pq = pk[q];
            const float* pa = (const float*)((const unsigned char*)inter + (pq & 0xffffu));
            const float* pb = (const float*)((const unsigned char*)inter + (pq >> 16));
#pragma unroll
            for (int k = 0; k < K16_SQ; ++k) {
              const float uk = pa[k], vk = pb[k];
              sc[k] = sc[k] + uk * vk;
              im[k] = im[k] + fabsf(uk) * fabsf(vk);
            }
          }
#pragma unroll
          for (int k = 0; k < K16_SQ; ++k) {
            ia[k] = ia[k] + im[k];
            So[k] = So[k] + fabsf(sc[k]);
          }
#if K16_ABLATE == 2   // all five squares' coefficients kept: three rows of sums
          gc[x] = sc[0];
          gc[B + x] = sc[1] + sc[3];
          gc[2 * B + x] = sc[2] + sc[4];
#else
          // the rows: sep = -f_n; slip, tip = (sq_a + sq_b) + s sq_2
          gc[x] = -xc[2][x];
          gc[B + x] = (sc[0] + sc[1]) + sc[2] * a.s_mu;
          gc[2 * B + x] = (sc[3] + sc[4]) + sc[2] * a.s_r;
#endif
        }
      }

      // the squares' error generators egen a0 + a0 egen and their abs sums;
      // the rows' egen abs sums (sep's is f_n's: Eg[2])
      float Eo[K16_SQ], Er1 = 0.0f, Er2 = 0.0f;
#pragma unroll
      for (int k = 0; k < K16_SQ; ++k) Eo[k] = 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (lane + 32 * h < E) {
          float sqe[K16_SQ];
#pragma unroll
          for (int k = 0; k < K16_SQ; ++k) {
            const float ev = h ? ev1[k] : ev0[k], a0 = xc[k][0];
            sqe[k] = ev * a0 + a0 * ev;
            Eo[k] += fabsf(sqe[k]);
          }
          Er1 += fabsf((sqe[0] + sqe[1]) + sqe[2] * a.s_mu);
          Er2 += fabsf((sqe[3] + sqe[4]) + sqe[2] * a.s_r);
        }
      }
#pragma unroll
      for (int k = 0; k < K16_SQ; ++k) {
        S[k] = pz_warp_sum(S[k]);
        Eg[k] = pz_warp_sum(Eg[k]);
        ia[k] = pz_warp_sum(ia[k]);
        So[k] = pz_warp_sum(So[k]);
        Eo[k] = pz_warp_sum(Eo[k]);
      }
      Er1 = pz_warp_sum(Er1);
      Er2 = pz_warp_sum(Er2);

      // each square's radius (pz_mul_coefs with b = a), then the slop
      // (pz_slop); every lane holds the sums
      float rd[K16_SQ];
#pragma unroll
      for (int k = 0; k < K16_SQ; ++k) {
        const float Sa = S[k], Ea = Eg[k], ar = xr[k], a0 = xc[k][0];
        const float ov = Sa * Sa - ia[k];
        const float overflow = ov < 0.0f ? 0.0f : ov;   // torch.clamp(min=0): NaN stays
        float r = (Sa + Ea) * ar + ar * (Sa + Ea);
        r = r + ar * ar;
        r = r + Ea * (Sa - fabsf(a0));
        r = r + (Sa - fabsf(a0)) * Ea;
        r = r + Ea * Ea;
        r = r + overflow;
        if (a.slop != 0.0f) r = r + a.slop * (So[k] + Eo[k] + r);
        rd[k] = r;
      }
      if (lane == 0) {
#if K16_ABLATE == 2
        a.g_rad[wt * 3] = rd[0];
        a.g_rad[wt * 3 + 1] = rd[1] + rd[3];
        a.g_rad[wt * 3 + 2] = rd[2] + rd[4];
#else
        a.g_rad[wt * 3] = xr[2] + Eg[2];
        a.g_rad[wt * 3 + 1] = ((rd[0] + rd[1]) + rd[2] * fabsf(a.s_mu)) + Er1;
        a.g_rad[wt * 3 + 2] = ((rd[3] + rd[4]) + rd[2] * fabsf(a.s_r)) + Er2;
#endif
      }
#endif
    }
    __syncthreads();   // the stage and the interleaved operands are free for the next tile
  }
}

extern "C" int k16_tables(const PZTables* t) { return pz_upload_tables(t); }

// the W ceil(T / K16_NG) tiles over a persistent grid of `grid` blocks;
// the basis tables uploaded (k16_tables)
extern "C" int k16_launch(const K16Args* args, int ld, int grid, void* stream) {
  if (args->normal < 0 || args->normal > 2 || args->pset < 0 || args->pset >= args->P ||
      grid < 1 || (long long)args->W * args->T * args->P * 3 >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = k16_smem(ld);
  const cudaError_t err = cudaFuncSetAttribute(
      k16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k16_kernel<<<(unsigned int)grid, K16_THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
