// Per-element polynomial-zonotope arithmetic in shared memory, shared by
// every PZ kernel: K1 (pz_matmul_linear.cu), K2 (pz_cross.cu), K9
// (fk_chain.cu), K10 (rnea_chain.cu) and K16 (grasp_rows.cu).  Keeping one copy of the
// arithmetic here is what keeps the op-level kernels and the fused chains
// from drifting apart.
//
// One thread group works on one batch element (a world, parameter set and
// time step).  A group is one warp (__syncwarp) or a few warps with a named
// barrier of their own (bar.sync id, n), so that every kernel runs several
// elements per block with no block-wide barrier between their ops; its size
// is a multiple of 32.  A PZ
// entry is packed in shared memory as
//     [coef 0..B) | egen B..B+E) | rad]       (ld = B + E + 1 floats)
// and a matrix of entries is a PZMat view: entry (r, c) starts at
// p + r * rs + c * cs (floats), so column slices are views.
// The pointer may also be a global one (K10 keeps its links' forces there).
//
// Every op is called by all threads of the group, reads operands that are
// ready, and ends with the group's barrier, so its output is ready for the
// next op.  Outputs never alias inputs, except pz_add, pz_add_scaled_axis
// and pz_add_cross_pz_const, which are elementwise and may write in place.
//
// Each op repeats the plain PyTorch version's formula term by term
// (armour_tpu_torch/pz/bpz.py, which follows armour_tpu/pz/bpz.py); only
// the order of long sums differs.  The abs masses (sum |coef|, sum |egen|)
// of an entry are taken by one warp in a fixed order: lane l sums the terms
// l, l + 32, ... in order, then a shuffle butterfly; so the masses, and
// every result, are the same bits whatever the group's size, and repeated
// calls give the same bits.  Built with -fmad=false and no fast math.
//
// The tables of the monomial basis live in constant memory (uploaded once
// per library by pz_upload_tables) and are copied to shared memory once a
// block of a persistent grid, since threads index them divergently.
#pragma once

#include <cuda_runtime.h>

#define PZ_MAXB 128
#define PZ_MAXE 64
#define PZ_MAXNF 8
#define PZ_MAXPAIRS 1024
#define PZ_TAB_BYTES 3520
#define PZ_MAXMASS 32          // entries one pz_masses call may take
#define PZ_MAXM 3              // inner dimension of pz_matmul_linear at most
#define PZ_MB 3                // entries a warp reduces at once
#define PZ_FULL 0xffffffffu

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

// The threads that work on one element: rank in [0, size), size a multiple
// of 32; bar 0 is the whole block, else a named barrier id (1..15).
struct PZGroup {
  int rank, size, bar;
};

__device__ __forceinline__ void pz_sync(const PZGroup& g) {
  if (g.size == 32) {
    __syncwarp();
  } else if (g.bar == 0) {
    __syncthreads();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(g.bar), "r"(g.size) : "memory");
  }
}

struct PZCtx {
  int B, E, nf, ld;
  const int* lin;
  const short* seg;
  const unsigned char* src;
  const unsigned char* ovf;
  const unsigned char* pi;
  const unsigned char* pj;
  float* mass;   // 4 * PZ_MAXMASS floats of the group's scratch
  PZGroup g;
};

struct PZMat {
  float* p;
  int rs, cs;
};

__device__ __forceinline__ float* pz_at(PZMat v, int r, int c) { return v.p + r * v.rs + c * v.cs; }
__device__ __forceinline__ PZMat pz_mat(float* p, int rs, int cs) { PZMat v = {p, rs, cs}; return v; }
__device__ __forceinline__ int pz_u(int o) { return (o + 1) % 3; }
__device__ __forceinline__ int pz_v(int o) { return (o + 2) % 3; }

// Copy the basis tables to shared memory (tab: PZ_TAB_BYTES bytes), by the
// whole block; ends with __syncthreads().
__device__ void pz_tables_init(unsigned char* tab) {
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
  __syncthreads();
}

// The context of one group over tables already in shared memory.
__device__ void pz_ctx(PZCtx& c, unsigned char* tab, float* mass, PZGroup g) {
  c.B = c_pz.B;
  c.E = c_pz.E;
  c.nf = c_pz.nf;
  c.ld = c.B + c.E + 1;
  c.lin = (const int*)tab;
  c.seg = (const short*)(tab + 32);
  c.src = tab + 32 + 2 * (PZ_MAXB + 2);
  c.ovf = c.src + PZ_MAXNF * PZ_MAXB;
  c.pi = c.ovf + PZ_MAXB;
  c.pj = c.pi + PZ_MAXPAIRS;
  c.mass = mass;
  c.g = g;
}

__device__ __forceinline__ float pz_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(PZ_FULL, v, off);
  return v;
}

// One entry's coefficients and error generators (packed: e = c + B).
struct PZEnt {
  const float* c;
  const float* e;
};

// Abs masses of N entries, a warp per MB entries (their chains
// interleave); entry k (ent(k)) gets S = sum_b |coef_b|, Ee = sum_q
// |egen_q|, A1 = sum_f |coef_lin(f)|, O = sum_b ovf_b |coef_b|, each summed
// by lane l over the terms l, l + 32, ... in order, then a shuffle
// butterfly, whatever warp takes it; put(k, S, Ee, A1, O) runs on every
// lane of that warp.
template <int MB, class Ent, class Put>
__device__ __forceinline__ void pz_mass_batches(const PZCtx& c, int N, Ent ent, Put put) {
  const int warp = c.g.rank >> 5, nw = c.g.size >> 5, lane = c.g.rank & 31;
  const int B = c.B, E = c.E;
  for (int k0 = warp * MB; k0 < N; k0 += nw * MB) {
    PZEnt p[MB];
    float s[MB], o[MB], e[MB], a1[MB];
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      p[u] = ent(min(k0 + u, N - 1));
      s[u] = 0.0f;
      o[u] = 0.0f;
      e[u] = 0.0f;
      a1[u] = 0.0f;
    }
#pragma unroll 4
    for (int b = lane; b < B; b += 32) {
      const bool ov = c.ovf[b] != 0;
#pragma unroll
      for (int u = 0; u < MB; ++u) {
        const float a = fabsf(p[u].c[b]);
        s[u] += a;
        if (ov) o[u] += a;
      }
    }
#pragma unroll 2
    for (int q = lane; q < E; q += 32) {
#pragma unroll
      for (int u = 0; u < MB; ++u) e[u] += fabsf(p[u].e[q]);
    }
#pragma unroll
    for (int f = 0; f < PZ_MAXNF; ++f) {
      if (f < c.nf) {
        const int li = c.lin[f];
#pragma unroll
        for (int u = 0; u < MB; ++u) a1[u] += fabsf(p[u].c[li]);
      }
    }
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      s[u] = pz_warp_sum(s[u]);
      o[u] = pz_warp_sum(o[u]);
      e[u] = pz_warp_sum(e[u]);
    }
#pragma unroll
    for (int u = 0; u < MB; ++u)
      if (k0 + u < N) put(k0 + u, s[u], e[u], a1[u], o[u]);
  }
}

// pz_mass_batches with PZ_MB entries a warp, or one where the group has
// three warps or more (they then work side by side): the same bits.
template <class Ent, class Put>
__device__ __forceinline__ void pz_mass_loop(const PZCtx& c, int N, Ent ent, Put put) {
  if (c.g.size >= 96) pz_mass_batches<1>(c, N, ent, put);
  else pz_mass_batches<PZ_MB>(c, N, ent, put);
}

// Abs masses of N packed entries, entry k at ent(k): c.mass[4k + 0..3] =
// S, E, A1, O as pz_mass_loop.  Ends with the group's barrier.
template <class EntPtr>
__device__ void pz_masses_of(const PZCtx& c, int N, EntPtr ent) {
  const int B = c.B;
  const bool lane0 = (c.g.rank & 31) == 0;
  float* mass = c.mass;
  pz_mass_loop(
      c, N,
      [&](int k) {
        const float* e = ent(k);
        PZEnt r = {e, e + B};
        return r;
      },
      [&](int k, float S, float Ee, float A1, float O) {
        if (lane0) {
          mass[4 * k + 0] = S;
          mass[4 * k + 1] = Ee;
          mass[4 * k + 2] = A1;
          mass[4 * k + 3] = O;
        }
      });
  pz_sync(c.g);
}

// Abs masses of the entries of two matrix views (n0 x m0, then n1 x m1;
// either may be empty), entry k row-major, view 0 first.
__device__ void pz_masses(const PZCtx& c, PZMat v0, int n0, int m0, PZMat v1, int n1, int m1) {
  const int N0 = n0 * m0;
  pz_masses_of(c, N0 + n1 * m1, [&](int k) {
    return k < N0 ? pz_at(v0, k / m0, k % m0)
                  : pz_at(v1, (k - N0) / m1, (k - N0) % m1);
  });
}

__device__ __forceinline__ void pz_masses1(const PZCtx& c, PZMat v, int n, int m) {
  pz_masses(c, v, n, m, v, 0, 1);
}

// The relative float slop of every product:
// rad <- rad + slop (sum |coef| + sum |egen| + rad), per entry of out.
__device__ void pz_slop(const PZCtx& c, PZMat out, int n, int p, float slop) {
  if (slop == 0.0f) return;
  const int B = c.B, rix = c.B + c.E;
  const bool lane0 = (c.g.rank & 31) == 0;
  pz_mass_loop(
      c, n * p,
      [&](int k) {
        const float* e = pz_at(out, k / p, k % p);
        PZEnt r = {e, e + B};
        return r;
      },
      [&](int k, float S, float Ee, float, float) {
        if (lane0) {
          float* e = pz_at(out, k / p, k % p);
          const float r = e[rix];
          e[rix] = r + slop * (S + Ee + r);
        }
      });
  pz_sync(c.g);
}

// f(k, x) for every k < N and x < c.ld, spread over the group (item
// k ld + x to thread item mod size), without a division per item.
template <class F>
__device__ __forceinline__ void pz_each(const PZCtx& c, int N, F f) {
  const int ld = c.ld, size = c.g.size;
  const int dk = size / ld, dx = size - dk * ld;
  int k = c.g.rank / ld, x = c.g.rank - k * ld;
  while (k < N) {
    f(k, x);
    x += dx;
    k += dk;
    if (x >= ld) {
      x -= ld;
      ++k;
    }
  }
}

// Where entry k of a global operand lies (src(k) of the loaders below): its
// coefficients (B floats), error generators (E floats) and radius.
struct PZSrc {
  const float* c;
  const float* e;
  const float* r;
};

// ---------------------------------------------------------------------------
// degree <= 1 matrix operands in compact form (K1's, K9's and K10's rotations)
// ---------------------------------------------------------------------------

// floats of a compact entry, [coef 0 | coef lin(0..nf) | egen (E) | rad | S | E | A1],
// rounded up to a multiple of 4 so that entries stay 16-byte aligned
__host__ __device__ __forceinline__ int pz_lin_ld(int nf, int E) {
  return (nf + E + 5 + 3) / 4 * 4;
}

// Load the n entries src(0..n) of a global operand into compact entries at
// dst, dst + ldl, ..., with their abs masses taken over every coefficient
// in pz_mass_loop's order: the same bits as the packed entry would give.  A
// warp takes MB entries at once with all their coefficients and error
// generators in flight together, and writes the compact values from its
// registers.  Ends with the group's barrier.
template <int MB, class Src>
__device__ __forceinline__ void pz_load_lin_batches(const PZCtx& c, float* dst, int n, Src src) {
  constexpr int NB = (PZ_MAXB + 31) / 32, NE = (PZ_MAXE + 31) / 32;
  const int B = c.B, E = c.E, nf = c.nf, ldl = pz_lin_ld(nf, E);
  const int warp = c.g.rank >> 5, nw = c.g.size >> 5, lane = c.g.rank & 31;
  // compact position of coefficient lane + 32 t (-1: none)
  int cpos[NB];
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const int b = lane + 32 * t;
    int p = b == 0 ? 0 : -1;
    for (int f = 0; f < nf; ++f)
      if (c.lin[f] == b) p = 1 + f;
    cpos[t] = p;
  }
  for (int k0 = warp * MB; k0 < n; k0 += nw * MB) {
    float cv[MB][NB], ev[MB][NE];
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const PZSrc s = src(min(k0 + u, n - 1));
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const int b = lane + 32 * t;
        cv[u][t] = b < B ? s.c[b] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < NE; ++t) {
        const int q = lane + 32 * t;
        ev[u][t] = q < E ? s.e[q] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const int k = k0 + u;
      if (k >= n) break;
      float s = 0.0f, e = 0.0f;
      float* d = dst + k * ldl;
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        if (lane + 32 * t < B) {
          s += fabsf(cv[u][t]);
          if (cpos[t] >= 0) d[cpos[t]] = cv[u][t];
        }
      }
#pragma unroll
      for (int t = 0; t < NE; ++t) {
        const int q = lane + 32 * t;
        if (q < E) {
          e += fabsf(ev[u][t]);
          d[1 + nf + q] = ev[u][t];
        }
      }
      s = pz_warp_sum(s);
      e = pz_warp_sum(e);
      if (lane == 0) {
        d[1 + nf + E] = *src(k).r;
        d[2 + nf + E] = s;
        d[3 + nf + E] = e;
      }
    }
  }
  pz_sync(c.g);
  // A1 = sum_f |coef lin(f)| in factor order, from the compact entry
  for (int k = c.g.rank; k < n; k += c.g.size) {
    float* d = dst + k * ldl;
    float a1 = 0.0f;
    for (int f = 0; f < nf; ++f) a1 += fabsf(d[1 + f]);
    d[4 + nf + E] = a1;
  }
  pz_sync(c.g);
}

// pz_load_lin_batches with five entries a warp in a group of one or two
// warps, two in a wider group: the same bits.
template <class Src>
__device__ __forceinline__ void pz_load_lin(const PZCtx& c, float* dst, int n, Src src) {
  if (c.g.size <= 64) pz_load_lin_batches<5>(c, dst, n, src);
  else pz_load_lin_batches<2>(c, dst, n, src);
}

// pz_load_lin of n contiguous entries (global coef [n, B], egen [n, E], rad [n]).
__device__ __forceinline__ void pz_load_lin(const PZCtx& c, float* dst, int n, const float* coef,
                                            const float* egen, const float* rad) {
  const int B = c.B, E = c.E;
  pz_load_lin(c, dst, n, [=](int k) {
    const PZSrc s = {coef + (long long)k * B, egen + (long long)k * E, rad + k};
    return s;
  });
}

// Load the n entries src(0..n) of a global operand into packed entries
// dst, dst + ld, ...  A warp takes MB entries at once with all their values
// in flight together, then writes them from its registers.  No barrier at
// the end: the caller loads all its operands, then syncs the group once.
template <int MB, class Src>
__device__ __forceinline__ void pz_load_batches(const PZCtx& c, float* dst, int n, Src src) {
  constexpr int NB = (PZ_MAXB + 31) / 32, NE = (PZ_MAXE + 31) / 32;
  const int B = c.B, E = c.E, ld = c.ld;
  const int warp = c.g.rank >> 5, nw = c.g.size >> 5, lane = c.g.rank & 31;
  for (int k0 = warp * MB; k0 < n; k0 += nw * MB) {
    float cv[MB][NB], ev[MB][NE], rv[MB];
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const PZSrc s = src(min(k0 + u, n - 1));
#pragma unroll
      for (int t = 0; t < NB; ++t) {
        const int b = lane + 32 * t;
        cv[u][t] = b < B ? s.c[b] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < NE; ++t) {
        const int q = lane + 32 * t;
        ev[u][t] = q < E ? s.e[q] : 0.0f;
      }
      rv[u] = *s.r;
    }
#pragma unroll
    for (int u = 0; u < MB; ++u) {
      const int k = k0 + u;
      if (k >= n) break;
      float* d = dst + k * ld;
#pragma unroll
      for (int t = 0; t < NB; ++t)
        if (lane + 32 * t < B) d[lane + 32 * t] = cv[u][t];
#pragma unroll
      for (int t = 0; t < NE; ++t)
        if (lane + 32 * t < E) d[B + lane + 32 * t] = ev[u][t];
      if (lane == 0) d[B + E] = rv[u];
    }
  }
}

// pz_load_batches with three entries a warp in a group of one warp, one in
// a wider group (its warps then load side by side).
template <class Src>
__device__ __forceinline__ void pz_load(const PZCtx& c, float* dst, int n, Src src) {
  if (c.g.size <= 32) pz_load_batches<3>(c, dst, n, src);
  else pz_load_batches<1>(c, dst, n, src);
}

// pz_load of n strided entries: entry k has its coefficients at coef + k cs
// (B floats), its error generators at egen + k es (E floats) and its radius
// at rad[k rs].
__device__ __forceinline__ void pz_load(const PZCtx& c, float* dst, int n, const float* coef,
                                        long long cs, const float* egen, long long es,
                                        const float* rad, long long rs) {
  pz_load(c, dst, n, [=](int k) {
    const PZSrc s = {coef + k * cs, egen + k * es, rad + k * rs};
    return s;
  });
}

// The a operand of pz_matmul_linear_t: compact entries (pz_load_lin); entry
// (i, j) at p + i rs + j cs, so a transpose is a view.
struct PZLinA {
  const float* p;
  int rs, cs;
  __device__ const float* ent(int i, int j) const { return p + i * rs + j * cs; }
  __device__ float c0(const PZCtx&, const float* e) const { return e[0]; }
  // two 16-byte loads (entries are 16-byte aligned), a third for nf = 8
  __device__ void coefs(const PZCtx& c, const float* e, float* k) const {
    const float4 u = ((const float4*)e)[0], w = ((const float4*)e)[1];
    k[0] = u.x; k[1] = u.y; k[2] = u.z; k[3] = u.w;
    k[4] = w.x; k[5] = w.y; k[6] = w.z; k[7] = w.w;
    k[8] = c.nf > 7 ? e[8] : 0.0f;
  }
  __device__ float eg(const PZCtx& c, const float* e, int x) const { return e[1 + c.nf + x - c.B]; }
  __device__ float rad(const PZCtx& c, const float* e) const { return e[1 + c.nf + c.E]; }
  __device__ void masses(const PZCtx& c, const float* e, int, int, float& S, float& Ee,
                         float& A1) const {
    S = e[2 + c.nf + c.E];
    Ee = e[3 + c.nf + c.E];
    A1 = e[4 + c.nf + c.E];
  }
};

// ---------------------------------------------------------------------------
// the ops
// ---------------------------------------------------------------------------

// Set n entries of a vector view to zero.
__device__ void pz_zero(const PZCtx& c, PZMat v, int n) {
  pz_each(c, n, [&](int k, int x) { pz_at(v, k, 0)[x] = 0.0f; });
  pz_sync(c.g);
}

// out = a over n entries of vector views.
__device__ void pz_copy(const PZCtx& c, PZMat a, PZMat out, int n) {
  pz_each(c, n, [&](int k, int x) { pz_at(out, k, 0)[x] = pz_at(a, k, 0)[x]; });
  pz_sync(c.g);
}

// out = a + b over n x m entries (bpz.add); out may be a or b.
__device__ void pz_add(const PZCtx& c, PZMat a, PZMat b, PZMat out, int n, int m) {
  pz_each(c, n * m, [&](int k, int x) {
    const int r = k / m, cc = k - m * r;
    pz_at(out, r, cc)[x] = pz_at(a, r, cc)[x] + pz_at(b, r, cc)[x];
  });
  pz_sync(c.g);
}

// v[ax] += sgn * (s * x) for a scalar PZ x given as (coef [B], egen [E],
// rad): bpz.add(v, _embed(bpz.scale(x, s), ax, sgn)); the other components
// gain exact zeros and are left as they are.
__device__ void pz_add_scaled_axis(const PZCtx& c, PZMat v, int ax, float sgn, float s,
                                   const float* xc, const float* xe, const float* xr) {
  const int ld = c.ld, B = c.B, rix = c.B + c.E;
  float* e = pz_at(v, ax, 0);
  for (int i = c.g.rank; i < ld; i += c.g.size) {
    if (i < B) e[i] = e[i] + sgn * (xc[i] * s);
    else if (i < rix) e[i] = e[i] + sgn * (xe[i - B] * s);
    else e[i] = e[i] + fabsf(sgn) * (xr[0] * fabsf(s));
  }
  pz_sync(c.g);
}

// out = a @ b for a matrix PZ a [n, m] of degree <= 1 in k and a matrix PZ
// b [m, p] (bpz.matmul_linear_plain; armour_tpu/pz/bpz.py:214-285); n, m <=
// PZ_MAXM.  Only coefficient 0 and the linear ones of a enter the product
// (the shift table); all of a's coefficients enter its mass Sa, as in the
// plain version.  mb: the masses of b's entries (entry (j, k) at
// mb[4 (j p + k)]).  A thread takes one (column, position) of the output:
// it reads b's values there and the shift table once, for every row.
template <class A>
__device__ void pz_matmul_linear_t(const PZCtx& c, const A& a, PZMat b, const float* mb,
                                   PZMat out, int n, int m, int p, float slop) {
  const int B = c.B, E = c.E, nf = c.nf, rix = B + E;
  pz_each(c, p, [&](int kk, int x) {
    float bx[PZ_MAXM];
#pragma unroll
    for (int j = 0; j < PZ_MAXM; ++j) bx[j] = j < m ? pz_at(b, j, kk)[x] : 0.0f;
    if (x < B) {
      float bs[PZ_MAXM][PZ_MAXNF];
#pragma unroll
      for (int f = 0; f < PZ_MAXNF; ++f) {
        const int s = f < nf ? c.src[f * B + x] : B;
#pragma unroll
        for (int j = 0; j < PZ_MAXM; ++j) bs[j][f] = (j < m && s < B) ? pz_at(b, j, kk)[s] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < PZ_MAXM; ++i) {
        if (i >= n) continue;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < PZ_MAXM; ++j) {
          if (j >= m) continue;
          float ak[1 + PZ_MAXNF];
          a.coefs(c, a.ent(i, j), ak);
          float fs = 0.0f;
#pragma unroll
          for (int f = 0; f < PZ_MAXNF; ++f)
            if (f < nf) fs += ak[1 + f] * bs[j][f];
          const float t = ak[0] * bx[j] + fs;
          acc = (j == 0) ? t : acc + t;
        }
        pz_at(out, i, kk)[x] = acc;
      }
    } else if (x < rix) {
      float b0[PZ_MAXM];
#pragma unroll
      for (int j = 0; j < PZ_MAXM; ++j) b0[j] = j < m ? pz_at(b, j, kk)[0] : 0.0f;
#pragma unroll
      for (int i = 0; i < PZ_MAXM; ++i) {
        if (i >= n) continue;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < PZ_MAXM; ++j) {
          if (j >= m) continue;
          const float* ae = a.ent(i, j);
          const float t = a.c0(c, ae) * bx[j] + a.eg(c, ae, x) * b0[j];
          acc = (j == 0) ? t : acc + t;
        }
        pz_at(out, i, kk)[x] = acc;
      }
    } else {
#pragma unroll
      for (int i = 0; i < PZ_MAXM; ++i) {
        if (i >= n) continue;
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < PZ_MAXM; ++j) {
          if (j >= m) continue;
          const float* ae = a.ent(i, j);
          const float* be = pz_at(b, j, kk);
          float Sa, Ea, A1;
          a.masses(c, ae, i, j, Sa, Ea, A1);
          const int ib = 4 * (j * p + kk);
          const float Sb = mb[ib], Eb = mb[ib + 1], Ov = mb[ib + 3];
          const float Ta = Sa + Ea, Tb = Sb + Eb, brad = bx[j], arad = a.rad(c, ae);
          const float a0 = a.c0(c, ae);
          const float t = Ta * brad + arad * (Tb + brad) + Ea * (Sb - fabsf(be[0]) + Eb)
                          + (Sa - fabsf(a0)) * Eb + A1 * Ov;
          acc = (j == 0) ? t : acc + t;
        }
        pz_at(out, i, kk)[x] = acc;
      }
    }
  });
  pz_sync(c.g);
  pz_slop(c, out, n, p, slop);
}

template <class T>
__device__ __forceinline__ T* pz_pick(int i, T* p0, T* p1, T* p2) {
  return i == 0 ? p0 : i == 1 ? p1 : p2;
}

// The coefficients of cross(a, b) (a0..a2, b0..b2 its components) by one
// warp, lanes over the monomials: all three components (ALL) or only
// component o, each a segment sum over the pairs sorted by output monomial
// whose in-basis abs mass is taken per pair before any contraction and
// summed by the warp in a fixed order; then the radius of each component
// the warp took (bpz.py:146-166).  The same bits either way.
template <bool ALL>
__device__ __forceinline__ void pz_cross_coefs(const PZCtx& c, const float* a0, const float* a1,
                                               const float* a2, const float* b0, const float* b1,
                                               const float* b2, float* o0, float* o1, float* o2,
                                               int o) {
  const int B = c.B, rix = c.B + c.E, lane = c.g.rank & 31;
  float ia0 = 0.0f, ia1 = 0.0f, ia2 = 0.0f;
  for (int x = lane; x < B; x += 32) {
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, i0 = 0.0f, i1 = 0.0f, i2 = 0.0f;
    const int q1 = c.seg[x + 1];
#pragma unroll 2
    for (int q = c.seg[x]; q < q1; ++q) {
      const int i = c.pi[q], j = c.pj[q];
      const float x0 = a0[i], x1 = a1[i], x2 = a2[i], y0 = b0[j], y1 = b1[j], y2 = b2[j];
      // component o: a[u] b[v] - a[v] b[u], u = o + 1, v = o + 2 (mod 3)
      if (ALL || o == 0) {
        s0 += x1 * y2 - x2 * y1;
        i0 += fabsf(x1) * fabsf(y2) + fabsf(x2) * fabsf(y1);
      }
      if (ALL || o == 1) {
        s1 += x2 * y0 - x0 * y2;
        i1 += fabsf(x2) * fabsf(y0) + fabsf(x0) * fabsf(y2);
      }
      if (ALL || o == 2) {
        s2 += x0 * y1 - x1 * y0;
        i2 += fabsf(x0) * fabsf(y1) + fabsf(x1) * fabsf(y0);
      }
    }
    if (ALL || o == 0) o0[x] = s0;
    if (ALL || o == 1) o1[x] = s1;
    if (ALL || o == 2) o2[x] = s2;
    ia0 += i0;
    ia1 += i1;
    ia2 += i2;
  }
  if (ALL || o == 0) ia0 = pz_warp_sum(ia0);
  if (ALL || o == 1) ia1 = pz_warp_sum(ia1);
  if (ALL || o == 2) ia2 = pz_warp_sum(ia2);
  if (ALL ? lane < 3 : lane == 0) {
    const int oc = ALL ? lane : o, u = pz_u(oc), v = pz_v(oc);
    const float ia = oc == 0 ? ia0 : oc == 1 ? ia1 : ia2;
    const float* au = pz_pick(u, a0, a1, a2);
    const float* av = pz_pick(v, a0, a1, a2);
    const float* bu = pz_pick(u, b0, b1, b2);
    const float* bv = pz_pick(v, b0, b1, b2);
    const float Sau = c.mass[4 * u], Sav = c.mass[4 * v];
    const float Eau = c.mass[4 * u + 1], Eav = c.mass[4 * v + 1];
    const float Sbu = c.mass[4 * (3 + u)], Sbv = c.mass[4 * (3 + v)];
    const float Ebu = c.mass[4 * (3 + u) + 1], Ebv = c.mass[4 * (3 + v) + 1];
    const float Tau = Sau + Eau, Tav = Sav + Eav, Tbu = Sbu + Ebu, Tbv = Sbv + Ebv;
    const float Sa0u = Sau - fabsf(au[0]), Sa0v = Sav - fabsf(av[0]);
    const float Sb0u = Sbu - fabsf(bu[0]), Sb0v = Sbv - fabsf(bv[0]);
    const float aru = au[rix], arv = av[rix], bru = bu[rix], brv = bv[rix];
    // _cross_abs(x, y)[o] = x[u] y[v] + x[v] y[u]
    const float overflow = fmaxf((Sau * Sbv + Sav * Sbu) - ia, 0.0f);
    pz_pick(oc, o0, o1, o2)[rix] = (Tau * brv + Tav * bru) + (aru * Tbv + arv * Tbu)
                                   + (aru * brv + arv * bru) + (Eau * Sb0v + Eav * Sb0u)
                                   + (Sa0u * Ebv + Sa0v * Ebu) + (Eau * Ebv + Eav * Ebu)
                                   + overflow;
  }
}

// out = a x b for 3-vector PZs (bpz.cross_plain: the pair-table bilinear
// product, armour_tpu/pz/bpz.py:120-167,481-484).  The coefficients and
// radii by pz_cross_coefs: a warp per component in a group of three warps
// or more, else the first warp takes all three, each pair's six operand
// values read once; then the error generators over the whole group.
__device__ void pz_cross(const PZCtx& c, PZMat a, PZMat b, PZMat out, float slop) {
  const int B = c.B, E = c.E;
  const int warp = c.g.rank >> 5, nw = c.g.size >> 5;
  pz_masses(c, a, 3, 1, b, 3, 1);
  const float* a0 = pz_at(a, 0, 0);
  const float* a1 = pz_at(a, 1, 0);
  const float* a2 = pz_at(a, 2, 0);
  const float* b0 = pz_at(b, 0, 0);
  const float* b1 = pz_at(b, 1, 0);
  const float* b2 = pz_at(b, 2, 0);
  float* o0 = pz_at(out, 0, 0);
  float* o1 = pz_at(out, 1, 0);
  float* o2 = pz_at(out, 2, 0);
  if (nw >= 3) {
    if (warp < 3) pz_cross_coefs<false>(c, a0, a1, a2, b0, b1, b2, o0, o1, o2, warp);
  } else if (warp == 0) {
    pz_cross_coefs<true>(c, a0, a1, a2, b0, b1, b2, o0, o1, o2, 0);
  }
  // error generators: cross(a.egen, b0) + cross(a0, b.egen)
  for (int it = c.g.rank; it < 3 * E; it += c.g.size) {
    const int o = it / E, x = B + it - E * o, u = pz_u(o), v = pz_v(o);
    const float* au = pz_pick(u, a0, a1, a2);
    const float* av = pz_pick(v, a0, a1, a2);
    const float* bu = pz_pick(u, b0, b1, b2);
    const float* bv = pz_pick(v, b0, b1, b2);
    pz_pick(o, o0, o1, o2)[x] =
        (au[x] * bv[0] - av[x] * bu[0]) + (au[0] * bv[x] - av[0] * bu[x]);
  }
  pz_sync(c.g);
  pz_slop(c, out, 3, 1, slop);
}

// The coefficients and the radius of a * b for one entry (bpz._mul: the
// pair-table bilinear product, armour_tpu/pz/bpz.py:120-170) by one warp,
// lanes over the monomials: each coefficient a segment sum over the pairs
// sorted by output monomial, in table order; the in-basis abs mass
// |a_i||b_j| taken per pair and summed per monomial, then by the warp in
// pz_mass_loop's order; then lane 0 the radius from the masses ma and mb
// (S at [0], E at [1]), its terms in the plain version's order.
__device__ __forceinline__ void pz_mul_coefs(const PZCtx& c, const float* a, const float* b,
                                             const float* ma, const float* mb, float* out) {
  const int B = c.B, rix = c.B + c.E, lane = c.g.rank & 31;
  float ia = 0.0f;
  for (int x = lane; x < B; x += 32) {
    float s = 0.0f, i = 0.0f;
    const int q1 = c.seg[x + 1];
#pragma unroll 2
    for (int q = c.seg[x]; q < q1; ++q) {
      const float u = a[c.pi[q]], v = b[c.pj[q]];
      s += u * v;
      i += fabsf(u) * fabsf(v);
    }
    out[x] = s;
    ia += i;
  }
  ia = pz_warp_sum(ia);
  if (lane == 0) {
    const float Sa = ma[0], Ea = ma[1], Sb = mb[0], Eb = mb[1];
    const float ov = Sa * Sb - ia;
    const float overflow = ov < 0.0f ? 0.0f : ov;    // torch.clamp(min=0): NaN stays
    const float ar = a[rix], br = b[rix];
    float rd = (Sa + Ea) * br + ar * (Sb + Eb);
    rd = rd + ar * br;
    rd = rd + Ea * (Sb - fabsf(b[0]));
    rd = rd + (Sa - fabsf(a[0])) * Eb;
    rd = rd + Ea * Eb;
    out[rix] = rd + overflow;
  }
}

// out[k] = a[k] * b[k] for n entries of vector views (bpz._mul), n <=
// PZ_MAXMASS / 2: the masses of a's and b's entries, then a warp per entry
// for its coefficients and radius (pz_mul_coefs), the group for the error
// generators a.egen b0 + a0 b.egen, then the slop.
__device__ void pz_mul(const PZCtx& c, PZMat a, PZMat b, PZMat out, int n, float slop) {
  const int B = c.B, E = c.E;
  const int warp = c.g.rank >> 5, nw = c.g.size >> 5;
  pz_masses(c, a, n, 1, b, n, 1);
  for (int k = warp; k < n; k += nw)
    pz_mul_coefs(c, pz_at(a, k, 0), pz_at(b, k, 0), c.mass + 4 * k, c.mass + 4 * (n + k),
                 pz_at(out, k, 0));
  for (int it = c.g.rank; it < n * E; it += c.g.size) {
    const int k = it / E, x = B + it - E * k;
    const float* pa = pz_at(a, k, 0);
    const float* pb = pz_at(b, k, 0);
    pz_at(out, k, 0)[x] = pa[x] * pb[0] + pa[0] * pb[x];
  }
  pz_sync(c.g);
  pz_slop(c, out, n, 1, slop);
}

// Component o of a x v at position x for a PZ 3-vector a (au = a[u],
// aw = a[v]) and a constant vector v (bpz.cross_pz_const; exact).
__device__ __forceinline__ float pz_cpc_at(const float* au, const float* aw, const float* v, int o,
                                           int x, int rix) {
  const int u = pz_u(o), w = pz_v(o);
  return x < rix ? au[x] * v[w] - aw[x] * v[u] : au[x] * fabsf(v[w]) + aw[x] * fabsf(v[u]);
}

// Component o of m x b at position x for a constant vector m and a PZ
// 3-vector b (bu = b[u], bw = b[v]) (bpz.cross_const; exact; K10's wrench
// update takes it inside one fused pass).
__device__ __forceinline__ float pz_cc_at(const float* mv, const float* bu, const float* bw, int o,
                                          int x, int rix) {
  const int u = pz_u(o), w = pz_v(o);
  return x < rix ? mv[u] * bw[x] - mv[w] * bu[x] : fabsf(mv[u]) * bw[x] + fabsf(mv[w]) * bu[x];
}

// out = a x v for a PZ 3-vector a and a constant vector v (bpz.cross_pz_const; exact).
__device__ void pz_cross_pz_const(const PZCtx& c, PZMat a, const float* v, PZMat out) {
  const int rix = c.B + c.E;
  pz_each(c, 3, [&](int o, int x) {
    pz_at(out, o, 0)[x] = pz_cpc_at(pz_at(a, pz_u(o), 0), pz_at(a, pz_v(o), 0), v, o, x, rix);
  });
  pz_sync(c.g);
}

// out = s + ((a x v) + t) for PZ 3-vectors s, a, t and a constant vector v:
// bpz.add(s, bpz.add(bpz.cross_pz_const(a, v), t)) in one pass; out may be s.
__device__ void pz_add_cross_pz_const(const PZCtx& c, PZMat s, PZMat a, const float* v, PZMat t,
                                      PZMat out) {
  const int rix = c.B + c.E;
  pz_each(c, 3, [&](int o, int x) {
    const float x_v = pz_cpc_at(pz_at(a, pz_u(o), 0), pz_at(a, pz_v(o), 0), v, o, x, rix);
    pz_at(out, o, 0)[x] = pz_at(s, o, 0)[x] + (x_v + pz_at(t, o, 0)[x]);
  });
  pz_sync(c.g);
}

// out = (cc + r [-1, 1]) b for a PZ vector b [n] (bpz.mul_interval,
// armour_tpu/pz/bpz.py:189): exact for an interval operand.
__device__ void pz_mul_interval(const PZCtx& c, float cc, float r, PZMat b, PZMat out, int n,
                                float slop) {
  const int rix = c.B + c.E;
  pz_masses1(c, b, n, 1);
  pz_each(c, n, [&](int i, int x) {
    const float* be = pz_at(b, i, 0);
    pz_at(out, i, 0)[x] = x < rix ? cc * be[x]
        : fabsf(cc) * be[rix] + r * (c.mass[4 * i] + c.mass[4 * i + 1] + be[rix]);
  });
  pz_sync(c.g);
  pz_slop(c, out, n, 1, slop);
}

// out = (C + R [-1, 1]) b for an interval matrix (C, R [n, m], row-major)
// and a matrix PZ b [m, p] (bpz.matmul_interval, armour_tpu/pz/bpz.py:341).
__device__ void pz_matmul_interval(const PZCtx& c, const float* C, const float* R, PZMat b,
                                   PZMat out, int n, int m, int p, float slop) {
  const int rix = c.B + c.E;
  pz_masses1(c, b, m, p);
  pz_each(c, n * p, [&](int k, int x) {
    const int i = k / p, kk = k - p * i;
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
  });
  pz_sync(c.g);
  pz_slop(c, out, n, p, slop);
}
