// Per-element polynomial-zonotope arithmetic in shared memory, shared by
// every PZ kernel: K1 (pz_matmul_linear.cu), K2 (pz_cross.cu), K9
// (fk_chain.cu) and K10 (rnea_chain.cu).  Keeping one copy of the
// arithmetic here is what keeps the op-level kernels and the fused chains
// from drifting apart.
//
// One block works on one batch element (a world, parameter set and time
// step).  A PZ entry is packed in shared memory as
//     [coef 0..B) | egen B..B+E) | rad]       (ld = B + E + 1 floats)
// and a matrix of entries is a PZMat view: entry (r, c) starts at
// p + r * rs + c * cs (floats), so transposes and column slices are views.
//
// Every op is called by all threads of the block, reads operands that are
// ready, and ends with __syncthreads(), so its output is ready for the next
// op.  Outputs never alias inputs, except pz_add and pz_add_scaled_axis,
// which are elementwise and may write in place.
//
// Each op repeats the plain PyTorch version's formula term by term
// (armour_tpu_torch/pz/bpz.py, which follows armour_tpu/pz/bpz.py); only
// the order of long sums differs.  The abs masses (sum |coef|, sum |egen|)
// are block reductions in a fixed order: chunks of PZ_CH terms summed by
// one thread each, then the chunk sums in order, so repeated calls give the
// same bits.  Built with -fmad=false and no fast math.
//
// The tables of the monomial basis live in constant memory (uploaded once
// per library by pz_upload_tables) and are copied to shared memory at the
// start of every block, since threads index them divergently.
#pragma once

#include <cuda_runtime.h>

#define PZ_MAXB 128
#define PZ_MAXE 64
#define PZ_MAXNF 8
#define PZ_MAXPAIRS 1024
#define PZ_CH 8
#define PZ_TAB_BYTES 3520
#define PZ_MAXMASS 32          // entries one pz_masses call may take
#define PZ_RED_FLOATS 1536     // reduction scratch, floats

struct PZTables {
  int B, E, nf, P;                        // monomials, error slots, factors, pairs
  int lin[PZ_MAXNF];                      // basis index of the linear monomial k_f
  short seg[PZ_MAXB + 2];                 // pairs seg[m]..seg[m+1]-1 land on monomial m
  unsigned char src[PZ_MAXNF * PZ_MAXB];  // [nf][B]: mono(m) = k_f mono(src); B = none
  unsigned char ovf[PZ_MAXB];             // k_f mono(m) leaves the basis for every f
  unsigned char pi[PZ_MAXPAIRS];          // pair table sorted by output monomial
  unsigned char pj[PZ_MAXPAIRS];
};

static __constant__ PZTables c_pz;

static inline int pz_upload_tables(const PZTables* t) {
  return (int)cudaMemcpyToSymbol(c_pz, t, sizeof(PZTables));
}

struct PZCtx {
  int B, E, nf, ld;
  const int* lin;
  const short* seg;
  const unsigned char* src;
  const unsigned char* ovf;
  const unsigned char* pi;
  const unsigned char* pj;
  float* red;    // PZ_RED_FLOATS of scratch
  float* mass;   // 4 * PZ_MAXMASS of scratch
};

struct PZMat {
  float* p;
  int rs, cs;
};

__device__ __forceinline__ float* pz_at(PZMat v, int r, int c) { return v.p + r * v.rs + c * v.cs; }
__device__ __forceinline__ PZMat pz_mat(float* p, int rs, int cs) { PZMat v = {p, rs, cs}; return v; }
__device__ __forceinline__ PZMat pz_t(PZMat v) { PZMat t = {v.p, v.cs, v.rs}; return t; }
// column c of a matrix view as a vector view (rows at rs)
__device__ __forceinline__ PZMat pz_col(PZMat v, int c) { PZMat t = {v.p + c * v.cs, v.rs, 0}; return t; }
__device__ __forceinline__ int pz_u(int o) { return (o + 1) % 3; }
__device__ __forceinline__ int pz_v(int o) { return (o + 2) % 3; }

// Copy the basis tables to shared memory (tab: PZ_TAB_BYTES bytes) and set
// up the context.  Ends with __syncthreads().
__device__ void pz_ctx_init(PZCtx& c, unsigned char* tab, float* red, float* mass) {
  int* lin = (int*)tab;
  short* seg = (short*)(tab + 32);
  unsigned char* src = tab + 32 + 2 * (PZ_MAXB + 2);
  unsigned char* ovf = src + PZ_MAXNF * PZ_MAXB;
  unsigned char* pi = ovf + PZ_MAXB;
  unsigned char* pj = pi + PZ_MAXPAIRS;
  const int B = c_pz.B, nf = c_pz.nf, P = c_pz.P;
  for (int i = threadIdx.x; i < nf * B; i += blockDim.x) src[i] = c_pz.src[i];
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    pi[i] = c_pz.pi[i];
    pj[i] = c_pz.pj[i];
  }
  for (int i = threadIdx.x; i <= B; i += blockDim.x) seg[i] = c_pz.seg[i];
  for (int i = threadIdx.x; i < B; i += blockDim.x) ovf[i] = c_pz.ovf[i];
  for (int i = threadIdx.x; i < nf; i += blockDim.x) lin[i] = c_pz.lin[i];
  c.B = B;
  c.E = c_pz.E;
  c.nf = nf;
  c.ld = B + c_pz.E + 1;
  c.lin = lin;
  c.seg = seg;
  c.src = src;
  c.ovf = ovf;
  c.pi = pi;
  c.pj = pj;
  c.red = red;
  c.mass = mass;
  __syncthreads();
}

// Abs masses of the entries of two matrix views (n0 x m0, then n1 x m1;
// either may be empty), in a fixed order.  For entry k (row-major, view 0
// first) c.mass[4k + 0..3] = S = sum_b |coef_b|, E = sum_q |egen_q|,
// A1 = sum_f |coef_lin(f)|, O = sum_b ovf_b |coef_b|.
__device__ void pz_masses(const PZCtx& c, PZMat v0, int n0, int m0, PZMat v1, int n1, int m1) {
  const int B = c.B, E = c.E;
  const int nc = (B + PZ_CH - 1) / PZ_CH, ne = (E + PZ_CH - 1) / PZ_CH;
  const int per = 2 * nc + ne;
  const int N0 = n0 * m0, N = N0 + n1 * m1;
  for (int it = threadIdx.x; it < N * (nc + ne); it += blockDim.x) {
    const int k = it / (nc + ne), ch = it % (nc + ne);
    const float* e = k < N0 ? pz_at(v0, k / m0, k % m0) : pz_at(v1, (k - N0) / m1, (k - N0) % m1);
    float* part = c.red + k * per;
    if (ch < nc) {
      float s = 0.0f, o = 0.0f;
      const int hi = min(B, (ch + 1) * PZ_CH);
      for (int b = ch * PZ_CH; b < hi; ++b) {
        const float a = fabsf(e[b]);
        s += a;
        if (c.ovf[b]) o += a;
      }
      part[ch] = s;
      part[nc + ch] = o;
    } else {
      const int q0 = (ch - nc) * PZ_CH, hi = min(E, q0 + PZ_CH);
      float s = 0.0f;
      for (int q = q0; q < hi; ++q) s += fabsf(e[B + q]);
      part[2 * nc + ch - nc] = s;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    const float* e = k < N0 ? pz_at(v0, k / m0, k % m0) : pz_at(v1, (k - N0) / m1, (k - N0) % m1);
    const float* part = c.red + k * per;
    float s = part[0], o = part[nc], ee = ne ? part[2 * nc] : 0.0f, a1 = 0.0f;
    for (int ch = 1; ch < nc; ++ch) {
      s += part[ch];
      o += part[nc + ch];
    }
    for (int ch = 1; ch < ne; ++ch) ee += part[2 * nc + ch];
    for (int f = 0; f < c.nf; ++f) a1 += fabsf(e[c.lin[f]]);
    c.mass[4 * k + 0] = s;
    c.mass[4 * k + 1] = ee;
    c.mass[4 * k + 2] = a1;
    c.mass[4 * k + 3] = o;
  }
  __syncthreads();
}

__device__ __forceinline__ void pz_masses1(const PZCtx& c, PZMat v, int n, int m) {
  pz_masses(c, v, n, m, v, 0, 1);
}

// The relative float slop of every product:
// rad <- rad + slop (sum |coef| + sum |egen| + rad), per entry of out.
__device__ void pz_slop(const PZCtx& c, PZMat out, int n, int p, float slop) {
  if (slop == 0.0f) return;
  pz_masses1(c, out, n, p);
  const int rix = c.B + c.E;
  for (int k = threadIdx.x; k < n * p; k += blockDim.x) {
    float* e = pz_at(out, k / p, k % p);
    const float r = e[rix];
    e[rix] = r + slop * (c.mass[4 * k] + c.mass[4 * k + 1] + r);
  }
  __syncthreads();
}

// Load n contiguous entries from global arrays (coef [n, B], egen [n, E],
// rad [n]) into shared entries at dst, dst + ld, ...
__device__ void pz_load(const PZCtx& c, float* dst, int n, const float* coef,
                        const float* egen, const float* rad) {
  const int B = c.B, E = c.E, ld = c.ld;
  for (int it = threadIdx.x; it < n * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld;
    dst[it] = x < B ? coef[k * B + x] : x < B + E ? egen[k * E + x - B] : rad[k];
  }
}

// Store the entries of a vector view (n entries) to contiguous global arrays.
__device__ void pz_store(const PZCtx& c, PZMat v, int n, float* coef, float* egen, float* rad) {
  const int B = c.B, E = c.E, ld = c.ld;
  for (int it = threadIdx.x; it < n * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld;
    const float val = pz_at(v, k, 0)[x];
    if (x < B) coef[k * B + x] = val;
    else if (x < B + E) egen[k * E + x - B] = val;
    else rad[k] = val;
  }
}

// Set n entries of a vector view to zero.
__device__ void pz_zero(const PZCtx& c, PZMat v, int n) {
  for (int it = threadIdx.x; it < n * c.ld; it += blockDim.x) pz_at(v, it / c.ld, 0)[it % c.ld] = 0.0f;
  __syncthreads();
}

// out = a + b over n x m entries (bpz.add); out may be a or b.
__device__ void pz_add(const PZCtx& c, PZMat a, PZMat b, PZMat out, int n, int m) {
  const int ld = c.ld;
  for (int it = threadIdx.x; it < n * m * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld, r = k / m, cc = k % m;
    pz_at(out, r, cc)[x] = pz_at(a, r, cc)[x] + pz_at(b, r, cc)[x];
  }
  __syncthreads();
}

// v[ax] += sgn * (s * x) for a scalar PZ x: bpz.add(v, _embed(bpz.scale(x, s),
// ax, sgn)); the other components gain exact zeros and are left as they are.
__device__ void pz_add_scaled_axis(const PZCtx& c, PZMat v, int ax, float sgn, float s,
                                   const float* x) {
  const int ld = c.ld, rix = c.B + c.E;
  float* e = pz_at(v, ax, 0);
  for (int i = threadIdx.x; i < ld; i += blockDim.x) {
    if (i < rix) e[i] = e[i] + sgn * (x[i] * s);
    else e[i] = e[i] + fabsf(sgn) * (x[i] * fabsf(s));
  }
  __syncthreads();
}

// out = a @ b for a matrix PZ a [n, m] of degree <= 1 in k and a matrix PZ
// b [m, p] (bpz.matmul_linear_plain; armour_tpu/pz/bpz.py:214-285).  Only
// coefficient 0 and the linear ones of a enter the product (the shift
// table); all of a's coefficients enter its mass Sa, as in the plain version.
__device__ void pz_matmul_linear(const PZCtx& c, PZMat a, PZMat b, PZMat out, int n, int m,
                                 int p, float slop) {
  const int B = c.B, E = c.E, ld = c.ld, nf = c.nf, rix = B + E;
  pz_masses(c, a, n, m, b, m, p);
  const float* ma = c.mass;
  const float* mb = c.mass + 4 * n * m;
  for (int it = threadIdx.x; it < n * p * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld, i = k / p, kk = k % p;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) {
      const float* ae = pz_at(a, i, j);
      const float* be = pz_at(b, j, kk);
      float t;
      if (x < B) {
        float fs = 0.0f;
        for (int f = 0; f < nf; ++f) {
          const int s = c.src[f * B + x];
          fs += ae[c.lin[f]] * (s < B ? be[s] : 0.0f);
        }
        t = ae[0] * be[x] + fs;
      } else if (x < rix) {
        t = ae[0] * be[x] + ae[x] * be[0];
      } else {
        const int ia = 4 * (i * m + j), ib = 4 * (j * p + kk);
        const float Sa = ma[ia], Ea = ma[ia + 1], A1 = ma[ia + 2];
        const float Sb = mb[ib], Eb = mb[ib + 1], Ov = mb[ib + 3];
        const float Ta = Sa + Ea, Tb = Sb + Eb, brad = be[rix], arad = ae[rix];
        t = Ta * brad + arad * (Tb + brad) + Ea * (Sb - fabsf(be[0]) + Eb)
            + (Sa - fabsf(ae[0])) * Eb + A1 * Ov;
      }
      acc = (j == 0) ? t : acc + t;
    }
    pz_at(out, i, kk)[x] = acc;
  }
  __syncthreads();
  pz_slop(c, out, n, p, slop);
}

__device__ __forceinline__ float pz_cabs(const float* x, const float* y, int o) {
  // component o of _cross_abs: x[u] y[v] + x[v] y[u]
  const int u = pz_u(o), v = pz_v(o);
  return x[u] * y[v] + x[v] * y[u];
}

// out = a x b for 3-vector PZs (bpz.cross_plain: the pair-table bilinear
// product, armour_tpu/pz/bpz.py:120-167,481-484).  Coefficients are a
// segment sum over the pairs sorted by output monomial; the in-basis abs
// mass is taken per pair before any contraction, then reduced.
__device__ void pz_cross(const PZCtx& c, PZMat a, PZMat b, PZMat out, float slop) {
  const int B = c.B, E = c.E, rix = B + E;
  const int nc = (B + PZ_CH - 1) / PZ_CH;
  pz_masses(c, a, 3, 1, b, 3, 1);
  // in-basis abs mass per (component, monomial), after the masses' scratch
  float* inabs = c.red + 6 * (2 * nc + (E + PZ_CH - 1) / PZ_CH);
  float* inpart = inabs + 3 * B;
  const float* a0 = pz_at(a, 0, 0);
  const float* a1 = pz_at(a, 1, 0);
  const float* a2 = pz_at(a, 2, 0);
  const float* b0 = pz_at(b, 0, 0);
  const float* b1 = pz_at(b, 1, 0);
  const float* b2 = pz_at(b, 2, 0);
  for (int it = threadIdx.x; it < 3 * (B + E); it += blockDim.x) {
    const int o = it / (B + E), x = it % (B + E);
    const int u = pz_u(o), v = pz_v(o);
    const float* au = u == 0 ? a0 : u == 1 ? a1 : a2;
    const float* av = v == 0 ? a0 : v == 1 ? a1 : a2;
    const float* bu = u == 0 ? b0 : u == 1 ? b1 : b2;
    const float* bv = v == 0 ? b0 : v == 1 ? b1 : b2;
    if (x < B) {
      float s = 0.0f, ia = 0.0f;
      for (int q = c.seg[x]; q < c.seg[x + 1]; ++q) {
        const int i = c.pi[q], j = c.pj[q];
        s += au[i] * bv[j] - av[i] * bu[j];
        ia += fabsf(au[i]) * fabsf(bv[j]) + fabsf(av[i]) * fabsf(bu[j]);
      }
      pz_at(out, o, 0)[x] = s;
      inabs[o * B + x] = ia;
    } else {
      // cross(a.egen, b0) + cross(a0, b.egen)
      pz_at(out, o, 0)[x] = (au[x] * bv[0] - av[x] * bu[0]) + (au[0] * bv[x] - av[0] * bu[x]);
    }
  }
  __syncthreads();
  for (int it = threadIdx.x; it < 3 * nc; it += blockDim.x) {
    const int o = it / nc, ch = it % nc, hi = min(B, (ch + 1) * PZ_CH);
    float s = 0.0f;
    for (int x = ch * PZ_CH; x < hi; ++x) s += inabs[o * B + x];
    inpart[it] = s;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    const int o = threadIdx.x;
    float ia = inpart[o * nc];
    for (int ch = 1; ch < nc; ++ch) ia += inpart[o * nc + ch];
    float Sa[3], Ea[3], Sb[3], Eb[3], Ta[3], Tb[3], Sa0[3], Sb0[3], ar[3], br[3];
    for (int q = 0; q < 3; ++q) {
      Sa[q] = c.mass[4 * q];
      Ea[q] = c.mass[4 * q + 1];
      Sb[q] = c.mass[4 * (3 + q)];
      Eb[q] = c.mass[4 * (3 + q) + 1];
      Ta[q] = Sa[q] + Ea[q];
      Tb[q] = Sb[q] + Eb[q];
      const float* ae = q == 0 ? a0 : q == 1 ? a1 : a2;
      const float* be = q == 0 ? b0 : q == 1 ? b1 : b2;
      Sa0[q] = Sa[q] - fabsf(ae[0]);
      Sb0[q] = Sb[q] - fabsf(be[0]);
      ar[q] = ae[rix];
      br[q] = be[rix];
    }
    const float overflow = fmaxf(pz_cabs(Sa, Sb, o) - ia, 0.0f);
    pz_at(out, o, 0)[rix] = pz_cabs(Ta, br, o) + pz_cabs(ar, Tb, o) + pz_cabs(ar, br, o)
                            + pz_cabs(Ea, Sb0, o) + pz_cabs(Sa0, Eb, o) + pz_cabs(Ea, Eb, o)
                            + overflow;
  }
  __syncthreads();
  pz_slop(c, out, 3, 1, slop);
}

// out = a x v for a PZ 3-vector a and a constant vector v (bpz.cross_pz_const; exact).
__device__ void pz_cross_pz_const(const PZCtx& c, PZMat a, const float* v, PZMat out) {
  const int ld = c.ld, rix = c.B + c.E;
  for (int it = threadIdx.x; it < 3 * ld; it += blockDim.x) {
    const int o = it / ld, x = it % ld, u = pz_u(o), w = pz_v(o);
    const float xu = pz_at(a, u, 0)[x], xw = pz_at(a, w, 0)[x];
    pz_at(out, o, 0)[x] = x < rix ? xu * v[w] - xw * v[u] : xu * fabsf(v[w]) + xw * fabsf(v[u]);
  }
  __syncthreads();
}

// out = m x b for a constant vector m and a PZ 3-vector b (bpz.cross_const; exact).
__device__ void pz_cross_const(const PZCtx& c, const float* mv, PZMat b, PZMat out) {
  const int ld = c.ld, rix = c.B + c.E;
  for (int it = threadIdx.x; it < 3 * ld; it += blockDim.x) {
    const int o = it / ld, x = it % ld, u = pz_u(o), w = pz_v(o);
    const float yu = pz_at(b, u, 0)[x], yw = pz_at(b, w, 0)[x];
    pz_at(out, o, 0)[x] = x < rix ? mv[u] * yw - mv[w] * yu
                                  : fabsf(mv[u]) * yw + fabsf(mv[w]) * yu;
  }
  __syncthreads();
}

// out = a v for a matrix PZ a [n, m] and a constant vector v [m]
// (bpz.matvec_cvec; exact).
__device__ void pz_matvec_cvec(const PZCtx& c, PZMat a, const float* v, PZMat out, int n, int m) {
  const int ld = c.ld, rix = c.B + c.E;
  for (int it = threadIdx.x; it < n * ld; it += blockDim.x) {
    const int i = it / ld, x = it % ld;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) {
      const float t = pz_at(a, i, j)[x] * (x < rix ? v[j] : fabsf(v[j]));
      acc = (j == 0) ? t : acc + t;
    }
    pz_at(out, i, 0)[x] = acc;
  }
  __syncthreads();
}

// out = a b for a matrix PZ a [n, m] and a PZ vector b [m] whose
// k-coefficients live only at the constant monomial (the link boxes;
// bpz.matvec_const_coef, armour_tpu/pz/bpz.py:303).
__device__ void pz_matvec_const_coef(const PZCtx& c, PZMat a, PZMat b, PZMat out, int n, int m,
                                     float slop) {
  const int B = c.B, E = c.E, ld = c.ld, rix = B + E;
  pz_masses(c, a, n, m, b, m, 1);
  const float* mb = c.mass + 4 * n * m;
  for (int it = threadIdx.x; it < n * ld; it += blockDim.x) {
    const int i = it / ld, x = it % ld;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) {
      const float* ae = pz_at(a, i, j);
      const float* be = pz_at(b, j, 0);
      const float b0 = be[0];
      float t;
      if (x < B) {
        t = ae[x] * b0;
      } else if (x < rix) {
        t = ae[0] * be[x] + ae[x] * b0;
      } else {
        const int ia = 4 * (i * m + j);
        const float Sa = c.mass[ia], Ea = c.mass[ia + 1], Eb = mb[4 * j + 1];
        t = (Sa + Ea) * be[rix] + ae[rix] * (fabsf(b0) + Eb + be[rix])
            + (Sa - fabsf(ae[0]) + Ea) * Eb;
      }
      acc = (j == 0) ? t : acc + t;
    }
    pz_at(out, i, 0)[x] = acc;
  }
  __syncthreads();
  pz_slop(c, out, n, 1, slop);
}

// out = (cc + r [-1, 1]) b for a PZ vector b [n] (bpz.mul_interval,
// armour_tpu/pz/bpz.py:189): exact for an interval operand.
__device__ void pz_mul_interval(const PZCtx& c, float cc, float r, PZMat b, PZMat out, int n,
                                float slop) {
  const int ld = c.ld, rix = c.B + c.E;
  pz_masses1(c, b, n, 1);
  for (int it = threadIdx.x; it < n * ld; it += blockDim.x) {
    const int i = it / ld, x = it % ld;
    const float* be = pz_at(b, i, 0);
    pz_at(out, i, 0)[x] = x < rix ? cc * be[x]
        : fabsf(cc) * be[rix] + r * (c.mass[4 * i] + c.mass[4 * i + 1] + be[rix]);
  }
  __syncthreads();
  pz_slop(c, out, n, 1, slop);
}

// out = (C + R [-1, 1]) b for an interval matrix (C, R [n, m], row-major)
// and a matrix PZ b [m, p] (bpz.matmul_interval, armour_tpu/pz/bpz.py:341).
__device__ void pz_matmul_interval(const PZCtx& c, const float* C, const float* R, PZMat b,
                                   PZMat out, int n, int m, int p, float slop) {
  const int ld = c.ld, rix = c.B + c.E;
  pz_masses1(c, b, m, p);
  for (int it = threadIdx.x; it < n * p * ld; it += blockDim.x) {
    const int k = it / ld, x = it % ld, i = k / p, kk = k % p;
    float acc = 0.0f;
    for (int j = 0; j < m; ++j) {
      const float* be = pz_at(b, j, kk);
      float t;
      if (x < rix) {
        t = C[i * m + j] * be[x];
      } else {
        const int ib = 4 * (j * p + kk);
        t = fabsf(C[i * m + j]) * be[rix]
            + fabsf(R[i * m + j]) * (c.mass[ib] + c.mass[ib + 1] + be[rix]);
      }
      acc = (j == 0) ? t : acc + t;
    }
    pz_at(out, i, kk)[x] = acc;
  }
  __syncthreads();
  pz_slop(c, out, n, p, slop);
}
