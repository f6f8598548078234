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
// MB, so one call is ~0.49 ms at 3.35 TB/s.  Since K13 forms its rows
// itself, only K4's full-set check reads them.  The ~1.5 kflop per cell is
// ~0.1 ms at 67 TFLOP/s: bound by the bytes written.
//
// Design, simple first: one thread per (world, cell), generators in
// registers, writes coalesced along the cell axis N (the layout K4 reads).
// The [C, 9, N] A.G intermediate of the JAX code (46 MB per world) is never
// materialised.  The per-cell arithmetic is hyperplane_cell.cuh, which K13
// (screen_collision.cu) compiles too, so the rows it forms again carry
// these bits.
//
// Built without fast math and with -fmad=false, and the normal is IEEE
// 1.0f / sqrtf(n2): an approximate rsqrt or a fused multiply-add changes A
// and delta, and with them the safety buffer.
#include <cuda_runtime.h>

#include "hyperplane_cell.cuh"

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

#define K3_C HCELL_C

__global__ void __launch_bounds__(256) k3_kernel(const K3Args args) {
  const long long N = (long long)args.T * args.J * args.O;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int w = blockIdx.y;
  if (n >= N) return;
  const long long tj = n / args.O;
  const int o = (int)(n % args.O);

  HCell h;
  hcell_load(args.shape_gens, args.radius, args.centers, args.gens, w,
             (long long)args.T * args.J, tj, args.O, o, h);
  float* Aw = args.A + (long long)w * 3 * K3_C * N;
  float* dw = args.d + (long long)w * K3_C * N;
  float* delw = args.delta + (long long)w * K3_C * N;
  hcell_rows(h, [&](int c, float A0, float A1, float A2, float d, float del) {
    Aw[(0 * K3_C + c) * N + n] = A0;
    Aw[(1 * K3_C + c) * N + n] = A1;
    Aw[(2 * K3_C + c) * N + n] = A2;
    dw[c * N + n] = d;
    delw[c * N + n] = del;
  });
}

extern "C" int k3_launch(const K3Args* args, void* stream) {
  const long long N = (long long)args->T * args->J * args->O;
  dim3 grid((unsigned int)((N + 255) / 256), (unsigned int)args->W);
  k3_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
