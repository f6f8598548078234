// K4: collision constraint rows at sliced link centres, and their gradients.
//
// Replaces armour_tpu/collision.py:255-302 (screened_constraints, the hard
// mode and, below, the smooth one) + collision.py:305-312
// (screened_constraint_grads), the counterpart
// of the reference's checkCollisionKernel; the same kernel over all
// N = T*J*O rows replaces collision.py:152-169 (collision_constraints, the
// finalize check that soundness rests on).  Per (world, query, row):
//
//   p = p_all[:, row];  candidates pos_c = A_c.p - (d_c + delta_c),
//   neg_c = -A_c.p - (-d_c + delta_c) in the order pos[0..C-1], neg[0..C-1]
//   (masked to -BIG for a degenerate normal);  g = -max (or -BIG for a
//   padded obstacle);  dg[f] = sum_a sign * A[a, comb] * dp_all[a, f, row].
//
// The argmax keeps the FIRST maximal candidate (strict > in index order),
// as jnp.argmax does: identical and antiparallel normals from parallel
// generator pairs, and rows masked at -BIG, tie often, and another choice
// gives another gradient even where g agrees.
//
// Bound on the H100 (flagship, W = 64, K = 4,096 screened rows, C = 36):
// the rows' A, d, delta are 189 MB, so a call is ~56 us at 3.35 TB/s
// whatever the number of query points (A is read once per query here, so
// the kernel itself moves Q times that).  The finalize call over all
// N = 35,840 rows reads 1.65 GB: ~0.49 ms.  ~300 flop per (query, row):
// bound by bytes.
//
// Design, simple first: one thread per (world, query, row), candidates
// scanned in registers, row data read coalesced along the row axis.
// Reading A once for all queries of a world is later work.
//
// The smooth mode (tau > 0, screened rows only: collision.py:277-290 of the
// JAX package, the branch cfg.smooth_obstacle_constraints turns on):
//
//   mx = max of the 2C candidates x,  w_c = expf((x_c - mx) / tau),  Z = sum w,
//   g = -(mx + tau logf(Z) - tau_log2c),
//   dg[f] = sum_a gp_a dp_all[a, f, row],  gp = -(sum_pos w A - sum_neg w A) / Z,
//
// by the rule K7 / K8 share (collision_rule.cuh): two passes over the row's
// candidates in the plain version's order (the max, then the exponentials
// against it: the row's 5C floats are read again, from L1 / L2).  It adds
// 2C expf and one logf per (query, row), each one special-function (MUFU)
// result: 19 M a query at 4,096 rows and 64 worlds, ~4.6 us at the card's
// 16 a clock per SM (4.18 T/s), so bound by bytes up to ~12 queries a call
// and by the exponentials above.  A template flag.
//
// At a link centre that is not finite (a line-search point after a failed
// Cholesky, nlp.py:newton_step) g is NaN in both modes, as the plain
// version's amax gives it.
//
// Built without fast math and with -fmad=false, so that g and the argmax
// repeat the plain version's float32 arithmetic operation for operation
// (expf / logf / the division by tau are the accurate library versions).
#include <cuda_runtime.h>

#include "collision_rule.cuh"

struct K4Args {
  const float* A;              // [W, 3, C, R]
  const float* d;              // [W, C, R]
  const float* delta;          // [W, C, R]
  const int* row;              // [W | 1, R] cell index into T*J
  long long row_ws;            // world stride of row (0: shared)
  const unsigned char* mask;   // [W, R] real-obstacle mask
  const float* p_all;          // [W, Q, 3, TJ]
  const float* dp_all;         // [W, Q, 3, F, TJ] or null
  float* g;                    // [W, Q, R]
  float* dg;                   // [W, Q, R, F] or null
  int W, Q, C, R, TJ, F;
  float tau;                   // > 0: the smooth mode (screened rows only)
  float tau_log2c;             // tau log(2C), rounded as the plain version rounds it
};

#define K4_BIG 1e8f

template <bool SMOOTH>
__global__ void __launch_bounds__(256) k4_kernel(const K4Args args) {
  const long long R = args.R;
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int q = blockIdx.y, w = blockIdx.z;
  if (r >= R) return;
  const int C = args.C;
  const long long TJ = args.TJ;
  const long long cell = args.row[w * args.row_ws + r];
  const float* pw = args.p_all + ((long long)w * args.Q + q) * 3 * TJ;
  const float p0 = pw[cell], p1 = pw[TJ + cell], p2 = pw[2 * TJ + cell];

  const float* Aw = args.A + (long long)w * 3 * C * R;
  const float* dw = args.d + (long long)w * C * R;
  const float* delw = args.delta + (long long)w * C * R;
  const bool real = args.mask[(long long)w * R + r] != 0;
  const long long out = ((long long)w * args.Q + q) * R + r;
  float g0, g1, g2;
  if constexpr (SMOOTH) {
    float m, gp0, gp1, gp2;
    const bool grad = args.dg != nullptr;
    collision_smooth_rule<1>(Aw, dw, delw, R, C, r, args.tau, args.tau_log2c, &p0, &p1, &p2,
                             &m, grad ? &gp0 : nullptr, &gp1, &gp2);
    args.g[out] = real ? -m : -K4_BIG;
    if (!grad) return;
    g0 = real ? gp0 : 0.0f;
    g1 = real ? gp1 : 0.0f;
    g2 = real ? gp2 : 0.0f;
  } else {
    // a NaN candidate (a link centre that is not finite) is the max and the
    // first NaN the argmax, as in torch.amax / argmax and jnp.max / argmax
    float best_p = 0.0f, best_n = 0.0f;
    int ip = 0, in = 0;
    for (int c = 0; c < C; ++c) {
      const float A0 = Aw[(0 * C + c) * R + r];
      const float A1 = Aw[(1 * C + c) * R + r];
      const float A2 = Aw[(2 * C + c) * R + r];
      const bool ok = fabsf(A0) + fabsf(A1) + fabsf(A2) > 0.0f;
      const float Ap = A0 * p0 + A1 * p1 + A2 * p2;
      const float dd = dw[c * R + r], de = delw[c * R + r];
      const float pos = ok ? Ap - (dd + de) : -K4_BIG;
      const float neg = ok ? -Ap - (-dd + de) : -K4_BIG;
      if (c == 0 || pos > best_p || (isnan(pos) && !isnan(best_p))) { best_p = pos; ip = c; }
      if (c == 0 || neg > best_n || (isnan(neg) && !isnan(best_n))) { best_n = neg; in = c; }
    }
    // pos candidates precede neg ones: a tie keeps the pos index
    const bool use_neg = best_n > best_p || (isnan(best_n) && !isnan(best_p));
    const float mx = use_neg ? best_n : best_p;
    const int comb = use_neg ? in : ip;
    const float sign = use_neg ? 1.0f : -1.0f;
    args.g[out] = real ? -mx : -K4_BIG;
    if (args.dg == nullptr) return;
    g0 = real ? sign * Aw[(0 * C + comb) * R + r] : 0.0f;
    g1 = real ? sign * Aw[(1 * C + comb) * R + r] : 0.0f;
    g2 = real ? sign * Aw[(2 * C + comb) * R + r] : 0.0f;
  }

  if (args.dg != nullptr) {
    const int F = args.F;
    const float* dpw = args.dp_all + ((long long)w * args.Q + q) * 3 * F * TJ;
    float* dgo = args.dg + out * F;
    for (int f = 0; f < F; ++f) {
      dgo[f] = g0 * dpw[(0 * F + f) * TJ + cell] + g1 * dpw[(1 * F + f) * TJ + cell]
               + g2 * dpw[(2 * F + f) * TJ + cell];
    }
  }
}

extern "C" int k4_launch(const K4Args* args, void* stream) {
  dim3 grid((unsigned int)((args->R + 255) / 256), (unsigned int)args->Q,
            (unsigned int)args->W);
  // the smooth mode takes screened rows only (row per world): the full-set
  // check stays exact
  if (args->tau > 0.0f) {
    if (args->row_ws == 0) return (int)cudaErrorInvalidValue;
    k4_kernel<true><<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  } else {
    k4_kernel<false><<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  }
  return (int)cudaGetLastError();
}
