// K4: collision constraint rows at sliced link centres, and their gradients.
//
// Replaces armour_tpu/collision.py:255-302 (screened_constraints, hard
// mode) + collision.py:305-312 (screened_constraint_grads), the counterpart
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
// Built without fast math and with -fmad=false, so that g and the argmax
// repeat the plain version's float32 arithmetic operation for operation.
#include <cuda_runtime.h>

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
};

#define K4_BIG 1e8f

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
    if (c == 0 || pos > best_p) { best_p = pos; ip = c; }
    if (c == 0 || neg > best_n) { best_n = neg; in = c; }
  }
  // pos candidates precede neg ones: a tie keeps the pos index
  const bool use_neg = best_n > best_p;
  const float m = use_neg ? best_n : best_p;
  const int comb = use_neg ? in : ip;
  const float sign = use_neg ? 1.0f : -1.0f;
  const bool real = args.mask[(long long)w * R + r] != 0;
  const long long out = ((long long)w * args.Q + q) * R + r;
  args.g[out] = real ? -m : -K4_BIG;

  if (args.dg != nullptr) {
    const float g0 = real ? sign * Aw[(0 * C + comb) * R + r] : 0.0f;
    const float g1 = real ? sign * Aw[(1 * C + comb) * R + r] : 0.0f;
    const float g2 = real ? sign * Aw[(2 * C + comb) * R + r] : 0.0f;
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
  k4_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
