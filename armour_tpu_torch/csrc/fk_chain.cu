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
// Only coefficient 0 and the linear ones of R_i enter the product through
// the shift table; all B of them enter R_i's abs mass, as the plain
// matmul_linear_right_plain takes it.  The JRS writes R of degree <= 1
// (jrs.assemble_rotations), the condition under which the product is exact.
//
// Bound on the H100 (flagship, W = 64, T = 128, B = 120, E = 38, J = 7):
// each element reads its 63 rotation entries (40 KB) and writes 21 link
// entries (13.4 KB): ~0.44 GB per call, ~0.13 ms at 3.35 TB/s; the
// ~0.4 MFLOP per element (3.3 GFLOP per call) take ~0.05 ms at 67 TFLOP/s,
// so the bound is the bytes.
//
// Design (K10's, rnea_chain.cu): a group of G threads per element (one
// warp; two below 8 elements an SM; eight, one element a block, for the
// W = 1 planner's 128 elements), up to eight elements per block, and a
// persistent grid that walks the elements.  Every op runs over the group and
// ends with the group's barrier (__syncwarp, or a named barrier), so there
// is no block-wide barrier after the tables and the link boxes are staged.
// Per element, shared memory holds 11.9 KB at the flagship widths:
//   - fk_r as four 3-entry row slots (three rows and a spare): R_i maps one
//     row at a time into the spare (row_k <- R_i^T row_k, so that
//     fk_r <- fk_r R_i, pz_matmul_linear_t with p = 1), then the slots swap,
//     so there is no second fk_r;
//   - fk_t, 3 entries;
//   - R_i in compact form (pz_load_lin: coefficient 0, the nf linear ones,
//     egen, rad and its abs masses over all B coefficients);
//   - the group's mass scratch, two halves: the masses of fk_r's rows, which
//     each row's slop takes anyway (the slop changes only rad), serve the
//     link product and the next joint's rotation.
// The link boxes, the same for every element, are staged once per block in
// compact form ([coef 0 | egen | rad]: their k-coefficients live only at
// the constant monomial), with their masses.  fk_t += fk_r trans_i is one
// pass; the link product goes to the spare slot, takes its slop, and
// link_i = that + fk_t is one pass that stores.  Every sum is the plain
// version's, term by term, and the abs masses are warp sums in a fixed
// order, so the result is the same bits whatever the geometry, and repeated
// calls give the same bits.  What bounds it on the card is the shared-memory
// pipe: the rotation's gathers through the shift table, not the FLOPs.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_ops.cuh"

#define K9_MAXJ 9
#define K9_SLOTS 4         // fk_r rows: three and a spare
#define K9_THREADS 256     // threads of a block at most

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
  long long n;       // elements, W T
  int J, Jr;         // joints in the chain, rotations per element in R
  float slop;
  float trans[K9_MAXJ + 1][3];
};

// the block's constants in shared memory, floats (a multiple of 4): the
// joint translations and the link boxes' abs masses
#define K9_CONST ((3 * (K9_MAXJ + 1) + 12 * K9_MAXJ + 3) / 4 * 4)

// floats of the staged link boxes: 3 K9_MAXJ compact entries of stride ldl
// (>= E + 2, a multiple of 4)
static __host__ __device__ __forceinline__ int k9_box_floats(int ldl) {
  return 3 * K9_MAXJ * ldl;
}

// floats of one group's shared memory: compact R, mass scratch, fk_r's row
// slots and fk_t; a multiple of 4, so that every group's R stays 16-byte aligned
static __host__ __device__ __forceinline__ int k9_group_floats(int ld, int ldl) {
  return (9 * ldl + 4 * PZ_MAXMASS + (3 * K9_SLOTS + 3) * ld + 3) / 4 * 4;
}

static __host__ __device__ __forceinline__ size_t k9_smem(int ld, int ldl, int NG) {
  return PZ_TAB_BYTES
      + sizeof(float) * (K9_CONST + k9_box_floats(ldl) + (size_t)NG * k9_group_floats(ld, ldl));
}

// pz_slop over 3 entries that also keeps their masses (S, E, A1, O) at
// mout[4 j]: the slop changes only rad, so they are the masses after it too.
__device__ __forceinline__ void k9_slop_keep(const PZCtx& c, float* out, float slop, float* mout) {
  const int B = c.B, ld = c.ld, rix = c.B + c.E;
  const bool lane0 = (c.g.rank & 31) == 0;
  pz_mass_loop(
      c, 3,
      [&](int k) {
        PZEnt r = {out + k * ld, out + k * ld + B};
        return r;
      },
      [&](int k, float S, float Ee, float A1, float O) {
        if (lane0) {
          float* e = out + k * ld;
          const float r = e[rix];
          if (slop != 0.0f) e[rix] = r + slop * (S + Ee + r);
          mout[4 * k + 0] = S;
          mout[4 * k + 1] = Ee;
          mout[4 * k + 2] = A1;
          mout[4 * k + 3] = O;
        }
      });
  pz_sync(c.g);
}

// at most 256 threads a block, two blocks an SM
__global__ void __launch_bounds__(K9_THREADS, 2) k9_kernel(const K9Args args, int G) {
  extern __shared__ float4 k9_smem_f4[];
  unsigned char* tab = (unsigned char*)k9_smem_f4;
  float* trans = (float*)(tab + PZ_TAB_BYTES);   // [J, 3]
  float* bmass = trans + 3 * (K9_MAXJ + 1);      // [J, 3, 4]: the boxes' abs masses
  float* boxes = trans + K9_CONST;               // [J, 3] compact entries
  const int J = args.J;
  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x) trans[i] = args.trans[i / 3][i % 3];
  pz_tables_init(tab);

  const int B = c_pz.B, E = c_pz.E, ld = B + E + 1, ldl = pz_lin_ld(c_pz.nf, E);
  const int rix = B + E;
  {
    // the link boxes in compact form (their k-coefficients live only at the
    // constant monomial: [coef 0 | egen | rad], stride ldl) and their masses,
    // by the whole block
    for (int it = threadIdx.x; it < 3 * J * ldl; it += blockDim.x) {
      const int k = it / ldl, x = it - k * ldl;
      boxes[it] = x == 0 ? args.bc[k * B] : x <= E ? args.be[k * E + x - 1]
                : x == E + 1 ? args.br[k] : 0.0f;
    }
    PZCtx cb;
    const PZGroup gb = {(int)threadIdx.x, (int)blockDim.x, 0};
    pz_ctx(cb, tab, bmass, gb);
    pz_mass_loop(
        cb, 3 * J,
        [&](int k) {
          PZEnt r = {args.bc + k * B, args.be + k * E};
          return r;
        },
        [&](int k, float S, float Ee, float A1, float O) {
          if ((threadIdx.x & 31) == 0) {
            bmass[4 * k + 0] = S;
            bmass[4 * k + 1] = Ee;
            bmass[4 * k + 2] = A1;
            bmass[4 * k + 3] = O;
          }
        });
    __syncthreads();   // the last block-wide barrier
  }

  float* groups = boxes + k9_box_floats(ldl);    // 16-byte aligned
  const int gi = threadIdx.x / G, NG = blockDim.x / G;
  float* rl = groups + gi * k9_group_floats(ld, ldl);   // R compact, 9 entries
  const PZGroup g = {(int)threadIdx.x % G, G, 1 + gi};
  PZCtx c;
  pz_ctx(c, tab, rl + 9 * ldl, g);
  float* slots = c.mass + 4 * PZ_MAXMASS;        // 4 row slots of 3 entries
  float* ft = slots + 3 * K9_SLOTS * ld;         // fk_t, 3 entries
  const PZLinA Rt = {rl, ldl, 3 * ldl};          // R_i^T: entry (i, j) is R_i[j][i]

  for (long long base = (long long)blockIdx.x * NG; base < args.n;
       base += (long long)gridDim.x * NG) {
    const long long e = base + gi;
    if (e >= args.n) break;
    // slot of fk_r's row k (k = 3: the spare) in bits 4k..4k+3
    unsigned sl = 0x3210u;
    int ms = 0;   // fk_r's masses at c.mass + ms, the next at c.mass + (ms ^ 36)
    auto row = [&](int k) { return slots + ((sl >> (4 * k)) & 15u) * 3 * ld; };
    auto swap_spare = [&](int k) {
      const unsigned a = (sl >> (4 * k)) & 15u, b = (sl >> 12) & 15u;
      sl = (sl & ~((15u << (4 * k)) | (15u << 12))) | (b << (4 * k)) | (a << 12);
    };
    // fk_r = I (coefficient 0 of the diagonal), fk_t = 0
    for (int it = g.rank; it < 15 * ld; it += G) {
      const int k = it / ld;
      if (k < 9) slots[it] = (it - k * ld == 0 && k / 3 == k % 3) ? 1.0f : 0.0f;
      else if (k >= 12) slots[it] = 0.0f;
    }
    // masses of fk_r = I (row k, entry j at c.mass[4 (3 k + j)]): S = O = 1 on
    // the diagonal (O when coefficient 0 overflows), E = A1 = 0
    for (int it = g.rank; it < 36; it += G) {
      const int k = it >> 2, q = it & 3;
      const bool d = k / 3 == k % 3;
      c.mass[it] = d && (q == 0 || (q == 3 && c.ovf[0])) ? 1.0f : 0.0f;
    }
    pz_sync(g);

    for (int i = 0; i < J; ++i) {
      // fk_t <- fk_t + fk_r trans_i (bpz.add of bpz.matvec_cvec), one pass
      const float* tr = trans + 3 * i;
      pz_each(c, 3, [&](int o, int x) {
        const float* ro = row(o);
        float acc = 0.0f;
        for (int j = 0; j < 3; ++j) {
          const float t = ro[j * ld + x] * (x < rix ? tr[j] : fabsf(tr[j]));
          acc = (j == 0) ? t : acc + t;
        }
        ft[o * ld + x] = ft[o * ld + x] + acc;
      });
      const long long r0 = (e * args.Jr + i) * 9;
      pz_load_lin(c, rl, 9, args.rc + r0 * B, args.re + r0 * E, args.rr + r0);
      // fk_r <- fk_r R_i, a row at a time into the spare slot (row_k <- R_i^T
      // row_k); the slop keeps the new rows' masses in the other half of the
      // mass scratch
      float* mnew = c.mass + (ms ^ 36);
      for (int k = 0; k < 3; ++k) {
        pz_matmul_linear_t(c, Rt, pz_mat(row(k), ld, 0), c.mass + ms + 12 * k,
                           pz_mat(row(3), ld, 0), 3, 3, 1, 0.0f);
        k9_slop_keep(c, row(3), args.slop, mnew + 12 * k);
        swap_spare(k);
      }
      ms ^= 36;

      // fk_r box_i (bpz.matvec_const_coef) into the spare slot, then its slop
      const float* bx = boxes + 3 * i * ldl;
      const float* bm = bmass + 12 * i;
      float* lk = row(3);
      pz_each(c, 3, [&](int o, int x) {
        const float* ro = row(o);
        float acc = 0.0f;
        for (int j = 0; j < 3; ++j) {
          const float* ae = ro + j * ld;
          const float* be = bx + j * ldl;   // [coef 0 | egen | rad]
          const float b0 = be[0];
          float t;
          if (x < B) {
            t = ae[x] * b0;
          } else if (x < rix) {
            t = ae[0] * be[1 + x - B] + ae[x] * b0;
          } else {
            const int ia = ms + 4 * (3 * o + j);
            const float Sa = c.mass[ia], Ea = c.mass[ia + 1], Eb = bm[4 * j + 1];
            t = (Sa + Ea) * be[1 + E] + ae[rix] * (fabsf(b0) + Eb + be[1 + E])
                + (Sa - fabsf(ae[0]) + Ea) * Eb;
          }
          acc = (j == 0) ? t : acc + t;
        }
        lk[o * ld + x] = acc;
      });
      pz_sync(g);
      pz_slop(c, pz_mat(lk, ld, 0), 3, 1, args.slop);
      // link_i = fk_r box_i + fk_t, stored
      const long long l0 = (e * J + i) * 3;
      pz_each(c, 3, [&](int o, int x) {
        const float v = lk[o * ld + x] + ft[o * ld + x];
        if (x < B) args.lc[(l0 + o) * B + x] = v;
        else if (x < rix) args.le[(l0 + o) * E + x - B] = v;
        else args.lr[l0 + o] = v;
      });
    }
    pz_sync(g);
  }
}

extern "C" int k9_tables(const PZTables* t) { return pz_upload_tables(t); }

// G threads per element (32, 64, 128 or 256), NG elements per block (G NG
// <= 256), grid blocks walking the n elements.
extern "C" int k9_launch(const K9Args* args, int ld, int ldl, int G, int NG, int grid,
                         void* stream) {
  const size_t smem = k9_smem(ld, ldl, NG);
  const int threads = G * NG;
  if (threads > K9_THREADS || G % 32 || NG > 15 || args->J > K9_MAXJ)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(k9_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  k9_kernel<<<(unsigned int)grid, threads, smem, (cudaStream_t)stream>>>(*args, G);
  return (int)cudaGetLastError();
}
