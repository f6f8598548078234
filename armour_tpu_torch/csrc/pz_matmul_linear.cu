// K1: product of a degree<=1 rotation PZ matrix with a PZ matrix.
//
// Replaces armour_tpu/pz/bpz.py:214-285 (matmul_linear) and, through
// transposed strides, bpz.py:294-300 (matmul_linear_right): the fused XLA
// op behind every rotation of the PZ forward kinematics and of both RNEA
// recursions (kinematics.py:103, dynamics.py:174,230; 21 calls per plan).
//
//   out[i,k] = sum_j a[i,j] (x) b[j,k]      a: [.., n, m], b: [.., m, p]
//
// with a's k-coefficients of degree <= 1, so a coefficient of out at
// monomial mono(x) only needs b's coefficient at mono(x)/k_f, read through
// the [nf, B] shift table src (sentinel B = zero pad).  Error generators
// take the linear cross terms, everything else is outward-rounded into rad
// exactly as the JAX code writes it, plus the relative float_slop.
//
// Bound on the H100 (flagship, per call, W = 64, T = 128, B = 120, E = 38):
// every operand and the result are ~5.7 KB per (world, time) element,
// 47-63 MB per operand, so one call moves 140-170 MB: ~42-51 us at
// 3.35 TB/s.  The arithmetic (~52 kflop per element) is under 10 us at the
// 67 TFLOP/s float32 rate, so the kernel is bound by bytes.
//
// Design, simple first: one block per batch element, 128 threads.  The
// block stages both operands' coef/egen in shared memory (coalesced along
// the monomial axis), one thread per output monomial accumulates all n*p
// entries, and the 63 abs-sums (Sa, Ea, Sb, Eb, A1, ovf mass) are serial
// per-thread loops.  The shift table lives in the kernel parameters
// (constant bank).  Sums run in a fixed order: results do not depend on the
// launch.  Fusing whole FK/RNEA chains to keep the carry on chip is later
// work.
//
// Built without fast math and with -fmad=false: IEEE float32 everywhere.
#include <cuda_runtime.h>

#include "pz_view.cuh"

#define K1_THREADS 128
#define K1_MAXB 128
#define K1_MAXE 64
#define K1_MAXN 3
#define K1_MAXM 3
#define K1_MAXP 4

struct K1Args {
  PZView a, b, out;
  int bd[3];
  int n, m, p;
  int B, E, nf;
  float slop;
  int lin[8];
  short src[1024];            // [nf][B]
  unsigned char ovf[256];     // [B]
};

__global__ void __launch_bounds__(K1_THREADS) k1_kernel(const K1Args args) {
  const int n = args.n, m = args.m, p = args.p;
  const int B = args.B, E = args.E, nf = args.nf;
  const int tid = threadIdx.x;

  __shared__ float s_ac[K1_MAXN * K1_MAXM * K1_MAXB];
  __shared__ float s_bc[K1_MAXM * K1_MAXP * (K1_MAXB + 1)];
  __shared__ float s_ae[K1_MAXN * K1_MAXM * K1_MAXE];
  __shared__ float s_be[K1_MAXM * K1_MAXP * K1_MAXE];
  __shared__ float s_oc[K1_MAXN * K1_MAXP * K1_MAXB];
  __shared__ float s_oe[K1_MAXN * K1_MAXP * K1_MAXE];
  __shared__ float s_ar[K1_MAXN * K1_MAXM], s_br[K1_MAXM * K1_MAXP];
  __shared__ float s_Sa[K1_MAXN * K1_MAXM], s_Ea[K1_MAXN * K1_MAXM], s_A1[K1_MAXN * K1_MAXM];
  __shared__ float s_Sb[K1_MAXM * K1_MAXP], s_Eb[K1_MAXM * K1_MAXP], s_ov[K1_MAXM * K1_MAXP];

  long long ix[3];
  pz_batch_index(blockIdx.x, args.bd, ix);
  const float* ac = args.a.coef + pz_off(args.a.cb, ix);
  const float* ae = args.a.egen + pz_off(args.a.eb, ix);
  const float* ar = args.a.rad + pz_off(args.a.rb, ix);
  const float* bc = args.b.coef + pz_off(args.b.cb, ix);
  const float* be = args.b.egen + pz_off(args.b.eb, ix);
  const float* br = args.b.rad + pz_off(args.b.rb, ix);

  // ---- stage operands ----
  for (int idx = tid; idx < n * m * B; idx += K1_THREADS) {
    int i = idx / (m * B), j = (idx / B) % m, b = idx % B;
    s_ac[idx] = ac[i * args.a.cv[0] + j * args.a.cv[1] + b];
  }
  for (int idx = tid; idx < n * m * E; idx += K1_THREADS) {
    int i = idx / (m * E), j = (idx / E) % m, e = idx % E;
    s_ae[idx] = ae[i * args.a.ev[0] + j * args.a.ev[1] + e];
  }
  for (int idx = tid; idx < m * p * (B + 1); idx += K1_THREADS) {
    int j = idx / (p * (B + 1)), k = (idx / (B + 1)) % p, b = idx % (B + 1);
    s_bc[idx] = (b < B) ? bc[j * args.b.cv[0] + k * args.b.cv[1] + b] : 0.0f;
  }
  for (int idx = tid; idx < m * p * E; idx += K1_THREADS) {
    int j = idx / (p * E), k = (idx / E) % p, e = idx % E;
    s_be[idx] = be[j * args.b.ev[0] + k * args.b.ev[1] + e];
  }
  if (tid < n * m) s_ar[tid] = ar[(tid / m) * args.a.rv[0] + (tid % m) * args.a.rv[1]];
  if (tid < m * p) s_br[tid] = br[(tid / p) * args.b.rv[0] + (tid % p) * args.b.rv[1]];
  __syncthreads();

  // ---- abs sums: Sa, Ea, A1 per a entry; Sb, Eb, overflow mass per b entry ----
  if (tid < n * m) {
    const float* c = s_ac + tid * B;
    const float* e = s_ae + tid * E;
    float sa = 0.0f, ea = 0.0f, a1 = 0.0f;
    for (int b = 0; b < B; ++b) sa += fabsf(c[b]);
    for (int q = 0; q < E; ++q) ea += fabsf(e[q]);
    for (int f = 0; f < nf; ++f) a1 += fabsf(c[args.lin[f]]);
    s_Sa[tid] = sa;
    s_Ea[tid] = ea;
    s_A1[tid] = a1;
  } else if (tid >= 32 && tid < 32 + m * p) {
    const int t = tid - 32;
    const float* c = s_bc + t * (B + 1);
    const float* e = s_be + t * E;
    float sb = 0.0f, eb = 0.0f, ov = 0.0f;
    for (int b = 0; b < B; ++b) {
      sb += fabsf(c[b]);
      if (args.ovf[b]) ov += fabsf(c[b]);
    }
    for (int q = 0; q < E; ++q) eb += fabsf(e[q]);
    s_Sb[t] = sb;
    s_Eb[t] = eb;
    s_ov[t] = ov;
  }

  // ---- coefficients: one thread per output monomial ----
  if (tid < B) {
    const int b = tid;
    for (int i = 0; i < n; ++i) {
      for (int k = 0; k < p; ++k) {
        float acc = 0.0f;
        for (int j = 0; j < m; ++j) {
          const float* arow = s_ac + (i * m + j) * B;
          const float* bcol = s_bc + (j * p + k) * (B + 1);
          float fs = 0.0f;
          for (int f = 0; f < nf; ++f) fs += arow[args.lin[f]] * bcol[args.src[f * B + b]];
          const float cj = arow[0] * bcol[b] + fs;
          acc = (j == 0) ? cj : acc + cj;
        }
        s_oc[(i * p + k) * B + b] = acc;
      }
    }
  }
  // ---- error generators: one thread per error slot ----
  if (tid < E) {
    const int q = tid;
    for (int i = 0; i < n; ++i) {
      for (int k = 0; k < p; ++k) {
        float acc = 0.0f;
        for (int j = 0; j < m; ++j) {
          const float ej = s_ac[(i * m + j) * B] * s_be[(j * p + k) * E + q]
                           + s_ae[(i * m + j) * E + q] * s_bc[(j * p + k) * (B + 1)];
          acc = (j == 0) ? ej : acc + ej;
        }
        s_oe[(i * p + k) * E + q] = acc;
      }
    }
  }
  __syncthreads();

  // ---- radius: one thread per output entry ----
  if (tid < n * p) {
    const int i = tid / p, k = tid % p;
    float r = 0.0f;
    for (int j = 0; j < m; ++j) {
      const int ia = i * m + j, ib = j * p + k;
      const float a0 = s_ac[ia * B], b0 = s_bc[ib * (B + 1)];
      const float Ta = s_Sa[ia] + s_Ea[ia], Tb = s_Sb[ib] + s_Eb[ib];
      const float rj = Ta * s_br[ib]
                       + s_ar[ia] * (Tb + s_br[ib])
                       + s_Ea[ia] * (s_Sb[ib] - fabsf(b0) + s_Eb[ib])
                       + (s_Sa[ia] - fabsf(a0)) * s_Eb[ib]
                       + s_A1[ia] * s_ov[ib];
      r = (j == 0) ? rj : r + rj;
    }
    if (args.slop != 0.0f) {
      float sc = 0.0f, se = 0.0f;
      for (int b = 0; b < B; ++b) sc += fabsf(s_oc[tid * B + b]);
      for (int q = 0; q < E; ++q) se += fabsf(s_oe[tid * E + q]);
      r = r + args.slop * (sc + se + r);
    }
    float* orad = args.out.rad + pz_off(args.out.rb, ix);
    orad[i * args.out.rv[0] + k * args.out.rv[1]] = r;
  }

  // ---- write coef / egen ----
  float* oc = args.out.coef + pz_off(args.out.cb, ix);
  float* oe = args.out.egen + pz_off(args.out.eb, ix);
  for (int idx = tid; idx < n * p * B; idx += K1_THREADS) {
    int i = idx / (p * B), k = (idx / B) % p, b = idx % B;
    oc[i * args.out.cv[0] + k * args.out.cv[1] + b] = s_oc[idx];
  }
  for (int idx = tid; idx < n * p * E; idx += K1_THREADS) {
    int i = idx / (p * E), k = (idx / E) % p, q = idx % E;
    oe[i * args.out.ev[0] + k * args.out.ev[1] + q] = s_oe[idx];
  }
}

extern "C" int k1_launch(const K1Args* args, long long blocks, void* stream) {
  k1_kernel<<<(unsigned int)blocks, K1_THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
