// K3: buffered-zonotope hyperplanes of every (time, link, obstacle) cell.
//
// Replaces armour_tpu/collision.py:99-130 (build_hyperplanes), the
// counterpart of the reference's bufferObstaclesKernel + polytope_PH.  Per
// cell n = (t*J + j)*O + o: the 9 generators (obstacle 3 | link shape 3 |
// diag(link radius) 3), the 36 pairwise cross products in
// itertools.combinations(range(9), 2) order, the unit normals A (0 for a
// degenerate pair, n2 == 0 exactly as in JAX), delta = sum_g |A . G_g| and
// d = A . obstacle centre.
//
// Bound on the H100 (flagship, W = 64, N = T*J*O = 35,840, C = 36): the
// outputs A [W,3,C,N] + d + delta [W,C,N] are 1.65 GB and the inputs a few
// MB, so one call is ~0.49 ms at 3.35 TB/s.  The ~1.5 kflop per cell is
// ~0.1 ms at 67 TFLOP/s: bound by the bytes written.
//
// Design, simple first: one thread per (world, cell), generators in
// registers, writes coalesced along the cell axis N (the layout the screen
// and K4 read).  The [C, 9, N] A.G intermediate of the JAX code (46 MB per
// world) is never materialised.
//
// Built without fast math and with -fmad=false, and the normal is IEEE
// 1.0f / sqrtf(n2): an approximate rsqrt or a fused multiply-add changes A
// and delta, and with them the safety buffer.
#include <cuda_runtime.h>

struct K3Args {
  const float* shape_gens;   // [W, T, J, 3, 3] (coord, generator)
  const float* radius;       // [W, T, J, 3]
  const float* centers;      // [W, O, 3]
  const float* gens;         // [W, O, 3, 3] (coord, generator)
  float* A;                  // [W, 3, C, N]
  float* d;                  // [W, C, N]
  float* delta;              // [W, C, N]
  int W, T, J, O;
};

#define K3_C 36

__global__ void __launch_bounds__(256) k3_kernel(const K3Args args) {
  const long long N = (long long)args.T * args.J * args.O;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (n >= N) return;
  const long long tj = n / args.O;
  const int o = (int)(n % args.O);

  float G[3][9];
  const float* og = args.gens + ((long long)w * args.O + o) * 9;
  const float* sg = args.shape_gens + ((long long)w * args.T * args.J + tj) * 9;
  const float* rd = args.radius + ((long long)w * args.T * args.J + tj) * 3;
  for (int a = 0; a < 3; ++a) {
    for (int g = 0; g < 3; ++g) {
      G[a][g] = og[a * 3 + g];
      G[a][3 + g] = sg[a * 3 + g];
      G[a][6 + g] = (a == g) ? rd[a] : 0.0f;
    }
  }
  const float* oc = args.centers + ((long long)w * args.O + o) * 3;
  const float c0 = oc[0], c1 = oc[1], c2 = oc[2];

  float* Aw = args.A + (long long)w * 3 * K3_C * N;
  float* dw = args.d + (long long)w * K3_C * N;
  float* delw = args.delta + (long long)w * K3_C * N;
  int c = 0;
  for (int ia = 0; ia < 9; ++ia) {
    for (int ib = ia + 1; ib < 9; ++ib, ++c) {
      const float cr0 = G[1][ia] * G[2][ib] - G[2][ia] * G[1][ib];
      const float cr1 = G[2][ia] * G[0][ib] - G[0][ia] * G[2][ib];
      const float cr2 = G[0][ia] * G[1][ib] - G[1][ia] * G[0][ib];
      const float n2 = cr0 * cr0 + cr1 * cr1 + cr2 * cr2;
      const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
      const float A0 = cr0 * inv, A1 = cr1 * inv, A2 = cr2 * inv;
      float del = 0.0f;
      for (int g = 0; g < 9; ++g) del += fabsf(A0 * G[0][g] + A1 * G[1][g] + A2 * G[2][g]);
      Aw[(0 * K3_C + c) * N + n] = A0;
      Aw[(1 * K3_C + c) * N + n] = A1;
      Aw[(2 * K3_C + c) * N + n] = A2;
      dw[c * N + n] = A0 * c0 + A1 * c1 + A2 * c2;
      delw[c * N + n] = del;
    }
  }
}

extern "C" int k3_launch(const K3Args* args, void* stream) {
  const long long N = (long long)args->T * args->J * args->O;
  dim3 grid((unsigned int)((N + 255) / 256), (unsigned int)args->W);
  k3_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
