// K4: collision constraint rows at sliced link centres, and their gradients.
//
// Replaces armour_tpu/collision.py:255-302 (screened_constraints, the hard
// mode and, below, the smooth one) + collision.py:305-312
// (screened_constraint_grads), the counterpart of the reference's
// checkCollisionKernel, and collision.py:152-169 (collision_constraints,
// the finalize check that soundness rests on).  Per (world, query, row):
//
//   p = p_all[:, row];  candidates pos_c = A_c.p - (d_c + delta_c),
//   neg_c = -A_c.p - (-d_c + delta_c) in the order pos[0..C-1], neg[0..C-1]
//   (masked to -BIG for a degenerate normal);  g = -max (or -BIG for a
//   padded obstacle);  dg[f] = sum_a sign * A[a, comb] * dp_all[a, f, row].
//
// The argmax keeps the FIRST maximal candidate (strict > in index order),
// as jnp.argmax does: identical and antiparallel normals from parallel
// generator pairs, and rows masked at -BIG, tie often, and another choice
// gives another gradient even where g agrees.  The rule is
// collision_rule.cuh's, one copy for K4 and K7 / K8.
//
// Three modes, one launch each:
//
// (a) the cell mode (A null: the full-set check of a plan, collision.py:
//     collision_constraints on Hyperplanes made from the cells).  One thread
//     per (world, row, group of G queries) loads the row's cell
//     (hyperplane_cell.cuh, K3's and K13's device code, so every row carries
//     K3's bits), walks its 36 rows one at a time and keeps the running pos
//     / neg maxima of its G queries in registers; no argmax, no dg.  The
//     threads of a world take its real rows first, then the padded ones,
//     which are -BIG without forming their rows; g is written along n =
//     (t J + j) O + o, nearly coalesced (the real obstacles of a time step
//     are consecutive where they are a prefix of the slots, as
//     pad_obstacles leaves them).  No [W, 3, C, N] tensor is read or made.
// (b) the row mode over shared rows (row [R], row_ws 0): the same check on
//     hyperplanes passed as tensors (Hyperplanes made from A / d / delta).
// (c) the screened rows (row [W, R]), also with dg and in the smooth mode.
//
// In (b) and (c) one thread takes (world, row, group of G queries): the
// row's 5C floats are read once per G queries (twice in the smooth mode),
// coalesced along the row axis.  G is a template parameter, instantiated
// for 1, 2, 4 and 6 only: the planning paths send the full-set check Q = 1
// or 2S' and the screened rows Q = S, S' and each times the 3 line-search
// alphas (S = 4 seeds, S' = 2 kept at the default profile: Q = 1, 2, 4, 6,
// 12), and the launcher's kernels/collision.py:k4_group gives them G = 1,
// 2, 4, 6, 6.  The queries of the last group past Q repeat query Q - 1 and
// are not written.  Every G gives G = 1's bits: each query's arithmetic is
// the same in the same order.
//
// Bound on the H100 (flagship, W = 64, T = 128, J = 7, O = 40; Q = 4):
// (a) moves ~42 MB (g and the inputs) and forms 36 hyperplanes of each real
//     row (~1,900 float32 operations each with their shared parts counted
//     once, as chip_smoke.py:k13_operations counts them, +-d + delta 2 a
//     hyperplane) and 9 operations a (query, hyperplane): ~4.0 GFLOP at ~21
//     real obstacles a world, ~0.06 ms at 67 TFLOP/s, bound by the
//     operations (chip_smoke.py:k4_cell_operations).  The tensor route read
//     K3's 1.65 GB (~0.49 ms) after K3 wrote it (~0.49 ms).
// (c) at K = 4,096 screened rows the rows' A, d, delta are 189 MB: ~56 us
//     at 3.35 TB/s, read once per group; bound by bytes.
//
// The smooth mode (tau > 0, screened rows only: collision.py:277-290 of the
// JAX package, the branch cfg.smooth_obstacle_constraints turns on):
//
//   mx = max of the 2C candidates x,  w_c = expf((x_c - mx) / tau),  Z = sum w,
//   g = -(mx + tau logf(Z) - tau_log2c),
//   dg[f] = sum_a gp_a dp_all[a, f, row],  gp = -(sum_pos w A - sum_neg w A) / Z,
//
// by the rule K7 / K8 share (collision_rule.cuh).  It adds 2C expf and one
// logf per (query, row), each one special-function (MUFU) result: 19 M a
// query at 4,096 rows and 64 worlds, ~4.6 us at the card's 16 a clock per SM
// (4.18 T/s), so bound by bytes up to ~12 queries a call and by the
// exponentials above.  A template flag.
//
// At a link centre that is not finite (a line-search point after a failed
// Cholesky, nlp.py:newton_step) g is NaN in every mode, as the plain
// version's amax gives it.
//
// Built without fast math and with -fmad=false, so that g and the argmax
// repeat the plain version's float32 arithmetic operation for operation
// (expf / logf / the division by tau are the accurate library versions).
#include <cuda_runtime.h>

#include "collision_rule.cuh"
#include "hyperplane_cell.cuh"

struct K4Args {
  const float* A;              // [W, 3, C, R], or null: the cell mode
  const float* d;              // [W, C, R]
  const float* delta;          // [W, C, R]
  const int* row;              // [W | 1, R] cell index into T*J
  long long row_ws;            // world stride of row (0: shared)
  const unsigned char* mask;   // [W, R] real-obstacle mask
  const float* shape_gens;     // the cell mode: [W, TJ, 3, 3] link shape generators
  const float* radius;         // [W, TJ, 3] link radii
  const float* centers;        // [W, O, 3] obstacle centres
  const float* gens;           // [W, O, 3, 3] obstacle generators (coord, generator)
  const unsigned char* obs_mask;  // [W, O] real-obstacle mask
  const float* p_all;          // [W, Q, 3, TJ]
  const float* dp_all;         // [W, Q, 3, F, TJ] or null
  float* g;                    // [W, Q, R]
  float* dg;                   // [W, Q, R, F] or null
  int W, Q, C, R, TJ, F, O;    // the cell mode: R = TJ O, C = 36
  int G;                       // queries a thread: 1, 2, 4 or K4_MAX_G
  float tau;                   // > 0: the smooth mode (screened rows only)
  float tau_log2c;             // tau log(2C), rounded as the plain version rounds it
};

#define K4_BIG 1e8f
#define K4_THREADS 256
#define K4_MAX_G 6

// the link centres of queries q0 .. q0 + G - 1 (past Q: query Q - 1) at cell
template <int G>
__device__ __forceinline__ void k4_points(const K4Args& a, int w, int q0, long long cell,
                                          float* p0, float* p1, float* p2) {
  const long long TJ = a.TJ;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int q = min(q0 + g, a.Q - 1);
    const float* pw = a.p_all + ((long long)w * a.Q + q) * 3 * TJ;
    p0[g] = pw[cell];
    p1[g] = pw[TJ + cell];
    p2[g] = pw[2 * TJ + cell];
  }
}

// Thread k of world w takes the world's k-th row in the order real rows
// first ((t J + j) major, the real obstacles in index order: a warp's lanes
// all form rows), then the padded ones, each only -BIG: padded obstacles
// (about half of the flagship's slots) no longer idle half of a warp.
template <int G>
__global__ void __launch_bounds__(K4_THREADS) k4_cells(const K4Args a) {
  extern __shared__ int k4_order[];   // [O]: the real obstacles, then the padded ones
  __shared__ int k4_nreal;
  const int w = blockIdx.z, O = a.O;
  const unsigned char* mw = a.obs_mask + (long long)w * O;
  if (threadIdx.x == 0) {
    int nr = 0;
    for (int o = 0; o < O; ++o)
      if (mw[o]) k4_order[nr++] = o;
    int np = nr;
    for (int o = 0; o < O; ++o)
      if (!mw[o]) k4_order[np++] = o;
    k4_nreal = nr;
  }
  __syncthreads();
  const long long R = a.R;
  const long long k = (long long)blockIdx.x * K4_THREADS + threadIdx.x;
  const int q0 = blockIdx.y * G;
  if (k >= R) return;
  const int nr = k4_nreal;
  const long long real_rows = (long long)a.TJ * nr;
  long long tj;
  int o;
  float m[G];
  if (k < real_rows) {
    tj = k / nr;
    o = k4_order[k - tj * nr];
    float p0[G], p1[G], p2[G], best_p[G], best_n[G];
    int ip[G], in[G];
    k4_points<G>(a, w, q0, tj, p0, p1, p2);
    HCell h;
    hcell_load(a.shape_gens, a.radius, a.centers, a.gens, w, a.TJ, tj, O, o, h);
    hcell_rows(h, [&](int c, float A0, float A1, float A2, float d, float del) {
      collision_hard_step<G, true>(c, A0, A1, A2, d, del, p0, p1, p2, best_p, best_n, ip, in);
    });
    collision_hard_pick<G, true>(best_p, best_n, ip, in, m, nullptr, nullptr);
  } else {
    const int np = O - nr;
    const long long j = k - real_rows;
    tj = j / np;
    o = k4_order[nr + (j - tj * np)];
#pragma unroll
    for (int g = 0; g < G; ++g) m[g] = K4_BIG;
  }
  const long long n = tj * O + o;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (q0 + g < a.Q) a.g[((long long)w * a.Q + q0 + g) * R + n] = -m[g];
  }
}

template <bool SMOOTH, int G>
__global__ void __launch_bounds__(K4_THREADS) k4_rows(const K4Args a) {
  const long long R = a.R;
  const long long r = (long long)blockIdx.x * K4_THREADS + threadIdx.x;
  const int q0 = blockIdx.y * G, w = blockIdx.z;
  if (r >= R) return;
  const int C = a.C;
  const long long TJ = a.TJ;
  const long long cell = a.row[w * a.row_ws + r];
  float p0[G], p1[G], p2[G], m[G], gp0[G], gp1[G], gp2[G];
  k4_points<G>(a, w, q0, cell, p0, p1, p2);

  const float* Aw = a.A + (long long)w * 3 * C * R;
  const float* dw = a.d + (long long)w * C * R;
  const float* delw = a.delta + (long long)w * C * R;
  const bool real = a.mask[(long long)w * R + r] != 0;
  const bool grad = a.dg != nullptr;
  if constexpr (SMOOTH) {
    collision_smooth_rule<G>(Aw, dw, delw, R, C, r, a.tau, a.tau_log2c, p0, p1, p2, m,
                             grad ? gp0 : nullptr, gp1, gp2);
  } else {
    int comb[G];
    float sign[G];
    collision_hard_rule<G, true>(Aw, dw, delw, R, C, r, p0, p1, p2, m, comb, sign);
    if (grad) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        gp0[g] = sign[g] * Aw[(0 * C + comb[g]) * R + r];
        gp1[g] = sign[g] * Aw[(1 * C + comb[g]) * R + r];
        gp2[g] = sign[g] * Aw[(2 * C + comb[g]) * R + r];
      }
    }
  }

  const int F = a.F;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int q = q0 + g;
    if (q >= a.Q) break;
    const long long out = ((long long)w * a.Q + q) * R + r;
    a.g[out] = real ? -m[g] : -K4_BIG;
    if (!grad) continue;
    const float g0 = real ? gp0[g] : 0.0f;
    const float g1 = real ? gp1[g] : 0.0f;
    const float g2 = real ? gp2[g] : 0.0f;
    const float* dpw = a.dp_all + ((long long)w * a.Q + q) * 3 * F * TJ;
    float* dgo = a.dg + out * F;
    for (int f = 0; f < F; ++f) {
      dgo[f] = g0 * dpw[(0 * F + f) * TJ + cell] + g1 * dpw[(1 * F + f) * TJ + cell]
               + g2 * dpw[(2 * F + f) * TJ + cell];
    }
  }
}

template <int G>
static void k4_launch_g(const K4Args& a, cudaStream_t stream) {
  dim3 grid((unsigned int)((a.R + K4_THREADS - 1) / K4_THREADS),
            (unsigned int)((a.Q + G - 1) / G), (unsigned int)a.W);
  if (a.A == nullptr)
    k4_cells<G><<<grid, K4_THREADS, a.O * sizeof(int), stream>>>(a);
  else if (a.tau > 0.0f)
    k4_rows<true, G><<<grid, K4_THREADS, 0, stream>>>(a);
  else
    k4_rows<false, G><<<grid, K4_THREADS, 0, stream>>>(a);
}

extern "C" int k4_launch(const K4Args* args, void* stream) {
  const K4Args& a = *args;
  // the smooth mode takes screened rows only (row per world): the full-set
  // check stays exact, and the cell mode gives values only
  if (a.tau > 0.0f && (a.row_ws == 0 || a.A == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.A == nullptr && (a.dg != nullptr || a.C != HCELL_C || a.R != a.TJ * a.O))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (a.G) {
    case 1: k4_launch_g<1>(a, s); break;
    case 2: k4_launch_g<2>(a, s); break;
    case 4: k4_launch_g<4>(a, s); break;
    case 6: k4_launch_g<6>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
