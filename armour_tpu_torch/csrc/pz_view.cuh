// Strided view of one batched polynomial-zonotope operand, shared by the
// PZ product kernels (pz_matmul_linear.cu, pz_cross.cu).
//
// A BPZ operand has coef [batch..., v0, v1, B], egen [batch..., v0, v1, E]
// and rad [batch..., v0, v1].  Up to three batch dims (worlds, parameter
// sets, time steps) are described by element strides, 0 where the operand
// is broadcast; v0/v1 are the matrix row/column dims (a vector uses v0
// only).  The trailing monomial / error axis is contiguous.  The Python
// wrapper fills this struct from tensor strides, so transposed operands and
// broadcast parameter axes are read in place, without copies.
#pragma once

#include "pz_ops.cuh"

struct PZView {
  float* coef;
  float* egen;
  float* rad;
  long long cb[3];  // coef batch strides
  long long eb[3];  // egen batch strides
  long long rb[3];  // rad batch strides
  long long cv[2];  // coef value-dim strides
  long long ev[2];  // egen value-dim strides
  long long rv[2];  // rad value-dim strides
};

// Batch coordinates of block `e` over batch sizes bd[3] (last fastest).
__device__ __forceinline__ void pz_batch_index(long long e, const int* bd, long long* ix) {
  ix[2] = e % bd[2];
  e /= bd[2];
  ix[1] = e % bd[1];
  ix[0] = e / bd[1];
}

__device__ __forceinline__ long long pz_off(const long long* s, const long long* ix) {
  return ix[0] * s[0] + ix[1] * s[1] + ix[2] * s[2];
}

// The entries of operand v at batch coordinates ix as a source for the
// loaders of pz_ops.cuh (pz_load, pz_load_lin): entry k is (k / m, k % m) of
// its matrix, read through the value strides, so a transposed or broadcast
// operand is read in place.
struct PZViewSrc {
  const float* c;
  const float* e;
  const float* r;
  long long c0, c1, e0, e1, r0, r1;
  int m;
  __device__ __forceinline__ PZSrc operator()(int k) const {
    const int i = k / m, j = k - i * m;
    const PZSrc s = {c + i * c0 + j * c1, e + i * e0 + j * e1, r + i * r0 + j * r1};
    return s;
  }
};

__device__ __forceinline__ PZViewSrc pz_view_src(const PZView& v, const long long* ix, int m) {
  const PZViewSrc s = {v.coef + pz_off(v.cb, ix), v.egen + pz_off(v.eb, ix),
                       v.rad + pz_off(v.rb, ix), v.cv[0], v.cv[1], v.ev[0], v.ev[1],
                       v.rv[0], v.rv[1], m};
  return s;
}
