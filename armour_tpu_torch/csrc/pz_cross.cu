// K2: PZ x PZ 3-vector cross product.
//
// Replaces armour_tpu/pz/bpz.py:120-167 (bilinear) as used by cross
// (bpz.py:481-484): the fused XLA op behind the PZ RNEA cross products
// (dynamics.py:168,179,202,216; 28 calls per plan, 194 with an uncertain
// COM).  The JAX code gathers both coefficient vectors through the
// 680-entry pair table, multiplies, and scatters into the B = 120 monomials
// with a one-hot [680, 120] matmul.
//
// Here the pair table is sorted by output monomial once on the host
// (pz/basis.py:pair_segments), so each output monomial is a fixed segment
// that one thread sums in table order: a static segment sum, no atomics, a
// result independent of the launch.  The in-basis abs mass |a_i||b_j| is
// taken per pair on the abs operands before any contraction (bpz.py:139),
// reduced over the block in a fixed tree order, and the overflow is
// max(absprod(Sa, Sb) - in_abs, 0).  Error generators and the radius follow
// bpz.py:146-166 term by term, plus the relative float_slop.
//
// Bound on the H100 (flagship, W = 64, T = 128, B = 120, E = 38): each
// operand and the result are ~1.9 KB per (world, [set,] time) element, so a
// call over 8,192-16,384 elements moves 47-78 MB: ~14-23 us at 3.35 TB/s.
// The ~16 kflop per element stays under 5 us at 67 TFLOP/s: bound by bytes.
//
// Design, simple first: one block per batch element, 128 threads (one per
// output monomial), both operands staged in shared memory.  Broadcasting
// over the parameter-set axis is a stride of 0 in the operand view.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_view.cuh"

#define K2_THREADS 128
#define K2_MAXB 128
#define K2_MAXE 64

struct K2Args {
  PZView a, b, out;
  int bd[3];
  int B, E, P;
  float slop;
  unsigned char pi[1024];     // pair table sorted by output monomial
  unsigned char pj[1024];
  short seg[260];             // pairs seg[m]..seg[m+1]-1 land on monomial m
};

__device__ __forceinline__ float cabs3(const float* x, const float* y, int o) {
  // component o of _cross_abs: x[o+1] y[o+2] + x[o+2] y[o+1] (indices mod 3)
  const int u = (o + 1) % 3, v = (o + 2) % 3;
  return x[u] * y[v] + x[v] * y[u];
}

__global__ void __launch_bounds__(K2_THREADS) k2_kernel(const K2Args args) {
  const int B = args.B, E = args.E;
  const int tid = threadIdx.x;

  __shared__ float s_a[3 * K2_MAXB], s_b[3 * K2_MAXB];
  __shared__ float s_ae[3 * K2_MAXE], s_be[3 * K2_MAXE];
  __shared__ float s_oc[3 * K2_MAXB], s_oe[3 * K2_MAXE];
  __shared__ float s_red[3 * K2_THREADS];
  __shared__ float s_S[4][3];      // Sa, Sb, Ea, Eb
  __shared__ float s_ar[3], s_br[3];

  long long ix[3];
  pz_batch_index(blockIdx.x, args.bd, ix);
  const float* ac = args.a.coef + pz_off(args.a.cb, ix);
  const float* ae = args.a.egen + pz_off(args.a.eb, ix);
  const float* ar = args.a.rad + pz_off(args.a.rb, ix);
  const float* bc = args.b.coef + pz_off(args.b.cb, ix);
  const float* be = args.b.egen + pz_off(args.b.eb, ix);
  const float* br = args.b.rad + pz_off(args.b.rb, ix);

  for (int idx = tid; idx < 3 * B; idx += K2_THREADS) {
    const int c = idx / B, b = idx % B;
    s_a[idx] = ac[c * args.a.cv[0] + b];
    s_b[idx] = bc[c * args.b.cv[0] + b];
  }
  for (int idx = tid; idx < 3 * E; idx += K2_THREADS) {
    const int c = idx / E, q = idx % E;
    s_ae[idx] = ae[c * args.a.ev[0] + q];
    s_be[idx] = be[c * args.b.ev[0] + q];
  }
  if (tid < 3) {
    s_ar[tid] = ar[tid * args.a.rv[0]];
    s_br[tid] = br[tid * args.b.rv[0]];
  }
  __syncthreads();

  // ---- abs sums over monomials / error slots, per component ----
  if (tid < 12) {
    const int which = tid / 3, c = tid % 3;
    const float* src = which == 0 ? s_a + c * B : which == 1 ? s_b + c * B
                     : which == 2 ? s_ae + c * E : s_be + c * E;
    const int len = which < 2 ? B : E;
    float s = 0.0f;
    for (int q = 0; q < len; ++q) s += fabsf(src[q]);
    s_S[which][c] = s;
  }

  // ---- coefficients: segment sum over the pairs landing on monomial tid ----
  float ia0 = 0.0f, ia1 = 0.0f, ia2 = 0.0f;
  if (tid < B) {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    for (int q = args.seg[tid]; q < args.seg[tid + 1]; ++q) {
      const int i = args.pi[q], j = args.pj[q];
      const float x0 = s_a[i], x1 = s_a[B + i], x2 = s_a[2 * B + i];
      const float y0 = s_b[j], y1 = s_b[B + j], y2 = s_b[2 * B + j];
      c0 += x1 * y2 - x2 * y1;
      c1 += x2 * y0 - x0 * y2;
      c2 += x0 * y1 - x1 * y0;
      const float ax0 = fabsf(x0), ax1 = fabsf(x1), ax2 = fabsf(x2);
      const float ay0 = fabsf(y0), ay1 = fabsf(y1), ay2 = fabsf(y2);
      ia0 += ax1 * ay2 + ax2 * ay1;
      ia1 += ax2 * ay0 + ax0 * ay2;
      ia2 += ax0 * ay1 + ax1 * ay0;
    }
    s_oc[tid] = c0;
    s_oc[B + tid] = c1;
    s_oc[2 * B + tid] = c2;
  }
  s_red[tid] = ia0;
  s_red[K2_THREADS + tid] = ia1;
  s_red[2 * K2_THREADS + tid] = ia2;

  // ---- error generators: cross(a.egen, b0) + cross(a0, b.egen) ----
  if (tid < E) {
    const float a0[3] = {s_a[0], s_a[B], s_a[2 * B]};
    const float b0[3] = {s_b[0], s_b[B], s_b[2 * B]};
    const float xe[3] = {s_ae[tid], s_ae[E + tid], s_ae[2 * E + tid]};
    const float ye[3] = {s_be[tid], s_be[E + tid], s_be[2 * E + tid]};
    for (int o = 0; o < 3; ++o) {
      const int u = (o + 1) % 3, v = (o + 2) % 3;
      s_oe[o * E + tid] = (xe[u] * b0[v] - xe[v] * b0[u]) + (a0[u] * ye[v] - a0[v] * ye[u]);
    }
  }
  __syncthreads();

  // fixed-order tree reduction of the in-basis abs mass
  for (int h = K2_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) {
      s_red[tid] += s_red[tid + h];
      s_red[K2_THREADS + tid] += s_red[K2_THREADS + tid + h];
      s_red[2 * K2_THREADS + tid] += s_red[2 * K2_THREADS + tid + h];
    }
    __syncthreads();
  }

  // ---- radius ----
  if (tid < 3) {
    const int o = tid;
    const float* Sa = s_S[0];
    const float* Sb = s_S[1];
    const float* Ea = s_S[2];
    const float* Eb = s_S[3];
    float Ta[3], Tb[3], Sb0[3], Sa0[3];
    for (int c = 0; c < 3; ++c) {
      Ta[c] = Sa[c] + Ea[c];
      Tb[c] = Sb[c] + Eb[c];
      Sb0[c] = Sb[c] - fabsf(s_b[c * B]);
      Sa0[c] = Sa[c] - fabsf(s_a[c * B]);
    }
    const float overflow = fmaxf(cabs3(Sa, Sb, o) - s_red[o * K2_THREADS], 0.0f);
    float r = cabs3(Ta, s_br, o) + cabs3(s_ar, Tb, o) + cabs3(s_ar, s_br, o)
              + cabs3(Ea, Sb0, o) + cabs3(Sa0, Eb, o) + cabs3(Ea, Eb, o) + overflow;
    if (args.slop != 0.0f) {
      float sc = 0.0f, se = 0.0f;
      for (int b = 0; b < B; ++b) sc += fabsf(s_oc[o * B + b]);
      for (int q = 0; q < E; ++q) se += fabsf(s_oe[o * E + q]);
      r = r + args.slop * (sc + se + r);
    }
    float* orad = args.out.rad + pz_off(args.out.rb, ix);
    orad[o * args.out.rv[0]] = r;
  }

  float* oc = args.out.coef + pz_off(args.out.cb, ix);
  float* oe = args.out.egen + pz_off(args.out.eb, ix);
  for (int idx = tid; idx < 3 * B; idx += K2_THREADS) {
    oc[(idx / B) * args.out.cv[0] + idx % B] = s_oc[idx];
  }
  for (int idx = tid; idx < 3 * E; idx += K2_THREADS) {
    oe[(idx / E) * args.out.ev[0] + idx % E] = s_oe[idx];
  }
}

extern "C" int k2_launch(const K2Args* args, long long blocks, void* stream) {
  k2_kernel<<<(unsigned int)blocks, K2_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
