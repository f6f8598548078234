// One cell's buffered-zonotope hyperplanes, shared by K3 (build_hyperplanes.cu,
// every cell to device memory), K13 (screen_collision.cu, which forms the
// rows it needs again instead of reading K3's tensors) and K4's cell mode
// (collision_rows.cu, the full-set check formed from the cells).
//
// A cell n = (t J + j) O + o buffers obstacle o with link j's generators at
// time t: its 9 generators G (obstacle 3 | link shape 3 | diag(link radius)
// 3), the 36 pairwise cross products in itertools.combinations(range(9), 2)
// order, the unit normals A (0 for a degenerate pair, n2 == 0 exactly as in
// JAX), delta = sum_g |A . G_g| summed left to right and d = A . obstacle
// centre (armour_tpu/collision.py:99-130).
//
// The three kernels compile this same code in libraries built without fast
// math and with -fmad=false, and the normal is IEEE 1.0f / sqrtf(n2): every
// row K13 and K4 form carries K3's bits.  An approximate rsqrt, a fused
// multiply-add or a reordered sum here changes A and delta, and with them
// the safety buffer and the screen's choice.
#pragma once
#include <cuda_runtime.h>

#define HCELL_C 36

struct HCell {
  float G[3][9];       // (coordinate, generator)
  float c0, c1, c2;    // the obstacle's centre
};

// cell (world w, link cell tj = t J + j, obstacle o) from the link shape
// generators [W, TJ, 3, 3], radii [W, TJ, 3] and the obstacles' centres
// [W, O, 3] and generators [W, O, 3, 3] (coordinate, generator)
__device__ __forceinline__ void hcell_load(const float* shape_gens, const float* radius,
                                           const float* centers, const float* gens,
                                           long long w, long long TJ, long long tj, int O, int o,
                                           HCell& h) {
  const float* og = gens + (w * O + o) * 9;
  const float* sg = shape_gens + (w * TJ + tj) * 9;
  const float* rd = radius + (w * TJ + tj) * 3;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      h.G[a][g] = og[a * 3 + g];
      h.G[a][3 + g] = sg[a * 3 + g];
      h.G[a][6 + g] = (a == g) ? rd[a] : 0.0f;
    }
  }
  const float* oc = centers + (w * O + o) * 3;
  h.c0 = oc[0];
  h.c1 = oc[1];
  h.c2 = oc[2];
}

// the cell's 36 rows in order: emit(c, A0, A1, A2, d, delta) for c = 0..35
template <class Emit>
__device__ __forceinline__ void hcell_rows(const HCell& h, Emit&& emit) {
  int c = 0;
#pragma unroll
  for (int ia = 0; ia < 9; ++ia) {
#pragma unroll
    for (int ib = ia + 1; ib < 9; ++ib, ++c) {
      const float cr0 = h.G[1][ia] * h.G[2][ib] - h.G[2][ia] * h.G[1][ib];
      const float cr1 = h.G[2][ia] * h.G[0][ib] - h.G[0][ia] * h.G[2][ib];
      const float cr2 = h.G[0][ia] * h.G[1][ib] - h.G[1][ia] * h.G[0][ib];
      const float n2 = cr0 * cr0 + cr1 * cr1 + cr2 * cr2;
      const float inv = n2 > 0.0f ? 1.0f / sqrtf(n2) : 0.0f;
      const float A0 = cr0 * inv, A1 = cr1 * inv, A2 = cr2 * inv;
      float del = 0.0f;
#pragma unroll
      for (int g = 0; g < 9; ++g)
        del += fabsf(A0 * h.G[0][g] + A1 * h.G[1][g] + A2 * h.G[2][g]);
      emit(c, A0, A1, A2, A0 * h.c0 + A1 * h.c1 + A2 * h.c2, del);
    }
  }
}
