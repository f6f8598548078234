// K7: one projected Gauss-Newton step of the ALM solver, rows to step.
//
// Replaces armour_tpu/nlp.py:475-493 (inner_step up to the line search):
// constraint_stack (nlp.py:189-254) with its Jacobian, phi/dphi
// (pz/basis.py:56,74), the link centres (collision.py:133,143), the
// screened collision rows (collision.py:255,305) and cho_solve.  Plain
// version: nlp.py:alm_newton_plain.  Per (world, seed):
//
//   c = clip(stack(k), -1e6),  z = lam + rho c,  active = z > 0
//   g = grad cost + sum_r J_r max(z_r, 0)
//   H = sum_r (J_r rho [active]) J_r^T + Hc + 1e-3 I          (lower triangle)
//   step = H^-1 g (7x7 Cholesky),  m0 = cost + sum_r [active] z_r^2 / (2 rho)
//   feas = all(c <= thr),  and the cost itself (the solve loop's tracker, K14)
//
// over the M = 2 T F + TG + K + 8 F rows (TG = 3 T grasp rows in a grasp
// plan, else 0), without writing the Jacobian.
//
// Bound on the H100 (flagship, W = 64, S = 4): a call must read each
// world's centre polynomials (1.29 MB), torque polynomials (0.43 MB) and
// screened rows (2.95 MB) once, ~0.30 GB, ~0.09 ms at 3.35 TB/s; ~7 MFLOP
// per (world, seed), ~1.8 GFLOP, ~0.03 ms at 67 TFLOP/s: bound by bytes.
//
// What held the first design back (one 256-thread CTA per (world, seed)):
// S x W CTAs (2-4 at W = 1), each streaming its world's ~4.7 MB alone while
// the S seeds re-read them through L2, and 91 KB of shared memory a CTA for
// the link centres and their gradients at every cell (two CTAs an SM; a
// limit on T J).  This design reads each row once for all S <= 8 seeds, in
// three launches on one stream, as K8 (alm_values.cu) does:
//
//   (a) rows: a CTA per (tile of R polynomial rows, world).  It stages its
//       R centre / torque rows (cp.async) while phi and dphi of every seed
//       are formed in shared memory; a thread per (row, basis vector) forms
//       the row's dot products for all seeds.  Centre rows go to the L2
//       scratch pd [W, S, T J, 3, 1 + F] (22 MB at W = 64, S = 4; a cell's
//       3 (1 + F) values are contiguous for (b)'s gathers).  Torque rows
//       become their two clipped stack rows (+u - hi, then -u - hi), grasp
//       rows their one (g + g_rad); a
//       thread per (seed, row) forms their terms of g (F), H's lower
//       triangle (F (F + 1) / 2), the penalty and the violation count,
//       summed over the tile by a fixed shuffle tree.
//   (b) collision: a CTA per (tile of RB screened rows, world); a thread per
//       row reads its 3 C normals, d and delta once and runs K4's rule
//       (alm_collision_at) for every seed at the row's cell, chains the
//       chosen normal through dp, and the CTA sums each seed's terms by a
//       fixed shuffle tree (alm_block_sum).
//   (c) finish: a CTA per (world, seed) sums the partials of (a) and (b) in
//       tile order (six chunks of tiles, then the chunks in order), adds the
//       state rows (alm_state_rows) and the cost (alm_cost), factors H (7x7
//       Cholesky) and writes step, m0, feas and the cost, and g and H when
//       asked; then, when AlmArgs.epi asks for it, the solve loop's ladder
//       for its (world, seed) from the step in its registers (K14's phase,
//       alm_loop.cuh: no launch of its own).
//
// R and RB come from kernels/solver.py:k7_geometry (the largest tiles that
// still give >= 2 x 132 CTAs).  No atomics: every sum has a fixed order, so
// repeated calls give the same bits.  Reordered against the first design:
// the 120-term dot products run over b in order (float4 by float4, as K8),
// and g, H, the penalty and the count are summed by tile (shuffle trees)
// and then over tiles, with the state rows last, not by thread and then
// over the block; the per-row arithmetic (k7_terms) is the first design's
// k7_row.  The seed loops run to SM, the smallest of 1, 2, 4, 8 that holds
// S (an instantiation each), not to 8.
#include "alm_rows.cuh"

#define K7_MAXS 8
#define K7A_THREADS 256
#define K7C_THREADS 256
#define K7C_CHUNKS 6

template <int NF>
struct K7Sizes {
  static constexpr int NV = 1 + NF;                  // value and k-gradient of a row
  static constexpr int NT = NF * (NF + 1) / 2;       // H's lower triangle
  static constexpr int NACC = NF + NT + 2;           // g, H, penalty, violations
};

// All terms of one clipped row added to acc [NACC] (the first design's k7_row).
template <int NF>
__device__ __forceinline__ void k7_terms(float c_raw, const float* J, float lam, float rho,
                                         float thr, float* acc) {
  constexpr int NT = K7Sizes<NF>::NT;
  const float c = alm_clip(c_raw);
  const float z = lam + rho * c;
  const bool act = z > 0.0f;
  const float w = act ? rho : 0.0f;
  const float le = act ? z : 0.0f;
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    acc[i] += J[i] * le;
    const float Jw = J[i] * w;
#pragma unroll
    for (int j = 0; j <= i; ++j) acc[NF + alm_lin(i, j)] += Jw * J[j];
  }
  acc[NF + NT] += act ? z * z : 0.0f;
  acc[NF + NT + 1] += (c <= thr) ? 0.0f : 1.0f;
}

// (a) polynomial rows: [0, 3 TJ) link centres, [3 TJ, 3 TJ + TF) torques,
// [3 TJ + TF, 3 TJ + TF + TG) grasp rows; SM >= S seed slots
template <int NF, int R, int SM>
__global__ void __launch_bounds__(K7A_THREADS) k7_rows_kernel(const AlmArgs a, float* pd,
                                                             float* part, int t_first,
                                                             int npart) {
  constexpr int NV = K7Sizes<NF>::NV, NACC = K7Sizes<NF>::NACC;
  constexpr int SEG = R < 32 ? R : 32;         // rows of one seed within a warp
  extern __shared__ float4 k7_smem[];
  __shared__ float red[SM][(R + 31) / 32][NACC];
  const int S = a.S, B = a.B, TJ = a.TJ, TF = a.TF;
  const int P = alm_pitch(B);
  float* kq = (float*)k7_smem;                 // [S][8]
  float* basis = kq + 8 * K7_MAXS;             // [S][NV][P]
  float* tile = basis + S * NV * P;            // [R][P]; then the torque values [R][S][NV]
  unsigned char* degs = (unsigned char*)(tile + R * P);   // [B][ALM_MAX_F]
  const int w = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  const int NC = 3 * TJ, NT = NC + TF, NR = NT + a.TG, r0 = t * R;

  const bool vec = B % 4 == 0;
  for (int row = tid >> 5; row < R; row += K7A_THREADS / 32) {
    const int rr = r0 + row;
    const float* src = rr < NC   ? a.center + ((long long)w * NC + rr) * B
                       : rr < NT ? a.u_coef + ((long long)w * TF + rr - NC) * B
                                 : a.g_coef + ((long long)w * a.TG + rr - NT) * B;
    float* dst = tile + row * P;
    if (vec && rr < NR) {
      for (int b4 = tid & 31; b4 < B / 4; b4 += 32) alm_cp16(dst + 4 * b4, src + 4 * b4);
      for (int b = B + (tid & 31); b < P; b += 32) dst[b] = 0.0f;
    } else {
      for (int b = tid & 31; b < P; b += 32) dst[b] = (b < B && rr < NR) ? src[b] : 0.0f;
    }
  }
  for (int i = tid; i < S * NF; i += K7A_THREADS)
    kq[(i / NF) * 8 + i % NF] = a.k[(long long)w * a.Q * NF + i];
  for (int i = tid; i < B * ALM_MAX_F; i += K7A_THREADS) degs[i] = a.degs[i];
  __syncthreads();
  for (int i = tid; i < S * P; i += K7A_THREADS) {
    const int s = i / P, b = i - P * s;
    float* out = basis + s * NV * P + b;
    if (b < B) {
      alm_basis_at<NF>(degs + b * ALM_MAX_F, kq + s * 8, out, P);
    } else {
#pragma unroll
      for (int v = 0; v < NV; ++v) out[v * P] = 0.0f;
    }
  }
  alm_cp_wait();
  __syncthreads();

  // a thread per (row, basis vector): the row's dot products for every seed
  constexpr int PAIRS = (R * NV + K7A_THREADS - 1) / K7A_THREADS;
  float dot[PAIRS][SM];
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int idx = tid + j * K7A_THREADS, row = idx / NV, v = idx - NV * row;
#pragma unroll
    for (int s = 0; s < SM; ++s) dot[j][s] = 0.0f;
    if (idx >= R * NV) continue;
    const float4* x4 = (const float4*)(tile + row * P);
    for (int b4 = 0; b4 < P / 4; ++b4) {
      const float4 x = x4[b4];
#pragma unroll
      for (int s = 0; s < SM; ++s) {
        if (s < S) {
          const float4 f = ((const float4*)(basis + (s * NV + v) * P))[b4];
          dot[j][s] += x.x * f.x;
          dot[j][s] += x.y * f.y;
          dot[j][s] += x.z * f.z;
          dot[j][s] += x.w * f.w;
        }
      }
    }
    const int rr = r0 + row;
    if (rr < NC) {
#pragma unroll
      for (int s = 0; s < SM; ++s)
        if (s < S) pd[(((long long)w * S + s) * NC + rr) * NV + v] = dot[j][s];
    }
  }
  if (r0 + R <= NC) return;                    // no torque row in this tile
  __syncthreads();                             // the staged rows are no longer read
  float* val = tile;
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int idx = tid + j * K7A_THREADS, row = idx / NV, v = idx - NV * row;
    if (idx < R * NV) {
#pragma unroll
      for (int s = 0; s < SM; ++s)
        if (s < S) val[(row * S + s) * NV + v] = dot[j][s];
    }
  }
  __syncthreads();

  // a thread per (seed, row): the terms of the row's clipped stack rows (two
  // for a torque row, one for a grasp row), summed over the tile's rows by a
  // fixed shuffle tree within each warp (SEG rows of one seed), then the
  // warps of a seed in order
  for (int base = 0; base < S * R; base += K7A_THREADS) {
    const int idx = base + tid, s = idx / R, row = idx - R * s;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
    const int rr = r0 + row;
    if (s < S && rr >= NC && rr < NT) {
      const int r = rr - NC;
      const float* lam = a.lam + ((long long)w * S + s) * a.M;
      const float rho = a.rho[(long long)w * S + s];
      const float* v = val + (row * S + s) * NV;
      const float hi = a.u_hi[(long long)w * TF + r];
      float J[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) J[f] = v[1 + f];
      k7_terms<NF>(v[0] - hi, J, lam[r], rho, a.thr_torque, acc);
#pragma unroll
      for (int f = 0; f < NF; ++f) J[f] = -v[1 + f];
      k7_terms<NF>(-v[0] - hi, J, lam[TF + r], rho, a.thr_torque, acc);
    } else if (s < S && rr >= NT && rr < NR) {
      const int r = rr - NT;
      const float* lam = a.lam + ((long long)w * S + s) * a.M;
      const float* v = val + (row * S + s) * NV;
      float J[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f) J[f] = v[1 + f];
      k7_terms<NF>(v[0] + a.g_rad[(long long)w * a.TG + r], J, lam[2 * TF + r],
                   a.rho[(long long)w * S + s], a.thr_grasp, acc);
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      float x = acc[i];
#pragma unroll
      for (int off = SEG / 2; off > 0; off >>= 1) x += __shfl_down_sync(ALM_FULL, x, off);
      if (row % SEG == 0 && s < S) red[s][row / 32][i] = x;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < S * NACC; idx += K7A_THREADS) {
    const int s = idx / NACC, i = idx - NACC * s;
    float x = red[s][0][i];
#pragma unroll
    for (int g = 1; g < (R + 31) / 32; ++g) x += red[s][g][i];
    part[(((long long)w * npart + t - t_first) * S + s) * NACC + i] = x;
  }
}

// (b) screened collision rows, a thread each, every seed; G >= S seeds slots
template <int NF, int G, int RB>
__global__ void __launch_bounds__(RB) k7_collision_kernel(const AlmArgs a, const float* pd,
                                                         float* part, int tile0, int npart) {
  constexpr int NV = K7Sizes<NF>::NV, NACC = K7Sizes<NF>::NACC;
  __shared__ float red[(RB / 32) * NACC];
  const int w = blockIdx.y, r = blockIdx.x * RB + threadIdx.x;
  const int S = a.S, K = a.K, C = a.C, NC = 3 * a.TJ;
  const bool live = r < K;
  const int cell = live ? a.row[(long long)w * K + r] : 0;
  const float* pw = pd + (long long)w * S * NC * NV + (long long)cell * 3 * NV;
  float p0[G], p1[G], p2[G], m[G], sign[G];
  int comb[G];
#pragma unroll
  for (int s = 0; s < G; ++s) {
    const bool on = live && s < S;
    p0[s] = on ? pw[(long long)s * NC * NV + 0 * NV] : 0.0f;
    p1[s] = on ? pw[(long long)s * NC * NV + 1 * NV] : 0.0f;
    p2[s] = on ? pw[(long long)s * NC * NV + 2 * NV] : 0.0f;
  }
  if (live) alm_collision_at<G>(a, w, r, p0, p1, p2, m, comb, sign);
  const bool real = live && a.mask[(long long)w * K + r] != 0;
  const float* Aw = a.A + (long long)w * 3 * C * K;
  const int row = 2 * a.TF + a.TG + r;
#pragma unroll
  for (int s = 0; s < G; ++s) {
    if (s >= S) break;
    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
    if (live) {
      const float g0 = real ? sign[s] * Aw[(0 * C + comb[s]) * K + r] : 0.0f;
      const float g1 = real ? sign[s] * Aw[(1 * C + comb[s]) * K + r] : 0.0f;
      const float g2 = real ? sign[s] * Aw[(2 * C + comb[s]) * K + r] : 0.0f;
      const float* dp = pw + (long long)s * NC * NV + 1;
      float J[NF];
#pragma unroll
      for (int f = 0; f < NF; ++f)
        J[f] = g0 * dp[0 * NV + f] + g1 * dp[1 * NV + f] + g2 * dp[2 * NV + f];
      const float gval = real ? -m[s] : -ALM_BIG;
      k7_terms<NF>(gval + a.col_margin, J, a.lam[((long long)w * S + s) * a.M + row],
                   a.rho[(long long)w * S + s], a.thr_col, acc);
    }
    alm_block_sum<NACC, RB / 32>(acc, red);
    if (threadIdx.x == 0) {
      float* o = part + (((long long)w * npart + tile0 + blockIdx.x) * S + s) * NACC;
#pragma unroll
      for (int i = 0; i < NACC; ++i) o[i] = acc[i];
    }
    __syncthreads();                           // red is taken again by the next seed
  }
}

// (c) the finish: partials in tile order, the state rows, the cost, the step
template <int NF>
__global__ void __launch_bounds__(K7C_THREADS) k7_finish_kernel(const AlmArgs a,
                                                               const float* part, int npart) {
  constexpr int NT = K7Sizes<NF>::NT, NACC = K7Sizes<NF>::NACC;
  __shared__ float chunk[K7C_CHUNKS][NACC];
  __shared__ float st[NF][4];                  // state rows of factor f: g_f, H_ff, pen, cnt
  __shared__ float kq[8];
  const int s = blockIdx.x, w = blockIdx.y, tid = threadIdx.x, S = a.S;
  const long long o = (long long)w * a.Q + s;
  if (tid < NF) kq[tid] = a.k[o * NF + tid];
  if (tid < NACC * K7C_CHUNKS) {
    const int i = tid % NACC, ch = tid / NACC;
    const int t0 = ch * npart / K7C_CHUNKS, t1 = (ch + 1) * npart / K7C_CHUNKS;
    const float* pp = part + (((long long)w * npart) * S + s) * NACC + i;
    float acc = 0.0f;
#pragma unroll 4
    for (int t = t0; t < t1; ++t) acc += pp[(long long)t * S * NACC];
    chunk[ch][i] = acc;
  }
  __syncthreads();
  if (tid < NF) {
    const int f = tid;
    const float* lam = a.lam + ((long long)w * S + s) * a.M;
    const float rho = a.rho[(long long)w * S + s];
    float c8[8], j8[8];
    alm_state_rows(a, a.limits, w, f, kq[f], c8, j8);
    float gf = 0.0f, hf = 0.0f, pe = 0.0f, co = 0.0f;
    for (int grp = 0; grp < 8; ++grp) {
      const float c = alm_clip(c8[grp]);
      const float z = lam[2 * a.TF + a.TG + a.K + grp * NF + f] + rho * c;
      const bool act = z > 0.0f;
      gf += j8[grp] * (act ? z : 0.0f);
      hf += (j8[grp] * (act ? rho : 0.0f)) * j8[grp];
      pe += act ? z * z : 0.0f;
      co += (c <= a.thr_state) ? 0.0f : 1.0f;
    }
    st[f][0] = gf;
    st[f][1] = hf;
    st[f][2] = pe;
    st[f][3] = co;
  }
  __syncthreads();
  if (tid != 0) return;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    float v = chunk[0][i];
#pragma unroll
    for (int ch = 1; ch < K7C_CHUNKS; ++ch) v += chunk[ch][i];
    acc[i] = v;
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    acc[f] += st[f][0];
    acc[NF + alm_lin(f, f)] += st[f][1];
    acc[NF + NT] += st[f][2];
    acc[NF + NT + 1] += st[f][3];
  }

  float kk[NF], gc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) kk[f] = kq[f];
  const float cost = alm_cost(a, w, kk, gc);
  const float* tr = a.traj + (long long)w * 5 * NF;
  const float rho = a.rho[(long long)w * S + s];
  float gv[NF], L[NF][NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    gv[i] = gc[i] + acc[i];
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float h = acc[NF + alm_lin(i, j)];
      if (i == j) {
        const float wi = a.kw * tr[3 * NF + i];
        h = (h + ((2.0f * a.cost_scale) * wi) * wi) + 1e-3f;
      }
      L[i][j] = h;
    }
  }
  if (a.g != nullptr) {
#pragma unroll
    for (int i = 0; i < NF; ++i) {
      a.g[o * NF + i] = gv[i];
#pragma unroll
      for (int j = 0; j < NF; ++j) a.H[(o * NF + i) * NF + j] = i >= j ? L[i][j] : L[j][i];
    }
  }
  // Cholesky H = L L^T in place (lower triangle), then L y = g, L^T x = y
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    float dsum = L[j][j];
#pragma unroll
    for (int t = 0; t < j; ++t) dsum -= L[j][t] * L[j][t];
    const float ljj = sqrtf(dsum);
    L[j][j] = ljj;
#pragma unroll
    for (int i = j + 1; i < NF; ++i) {
      float v = L[i][j];
#pragma unroll
      for (int t = 0; t < j; ++t) v -= L[i][t] * L[j][t];
      L[i][j] = v / ljj;
    }
  }
  float y[NF];
#pragma unroll
  for (int i = 0; i < NF; ++i) {
    float v = gv[i];
#pragma unroll
    for (int t = 0; t < i; ++t) v -= L[i][t] * y[t];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = NF - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int t = i + 1; t < NF; ++t) v -= L[t][i] * y[t];
    y[i] = v / L[i][i];
  }
#pragma unroll
  for (int i = 0; i < NF; ++i) a.step[o * NF + i] = y[i];
  a.value[o] = cost + acc[NF + NT] / (2.0f * rho);
  const bool feas = acc[NF + NT + 1] == 0.0f;
  a.feas[o] = feas ? 1 : 0;
  if (a.cost != nullptr) a.cost[o] = cost;
  // the solve loop's ladder on this (world, seed): its tracker and line-search points
  if (a.epi.phase == ALM_EPI_LADDER) alm_epi_ladder(a.epi, o, kk, y, feas, cost, NF);
}

static size_t k7_rows_smem(int B, int NV, int S, int R) {
  const int P = alm_pitch(B);
  return sizeof(float) * (8 * K7_MAXS + (size_t)S * NV * P + (size_t)R * P) + (size_t)B * ALM_MAX_F;
}

template <int NF, int R, int SM>
static int k7_rows_s(const AlmArgs* a, float* pd, float* part, int t_first, int npart,
                     void* stream) {
  // dynamic beside the static partial sums: above 48 KB together only by opt-in
  const size_t smem = k7_rows_smem(a->B, K7Sizes<NF>::NV, a->S, R);
  cudaError_t err = cudaFuncSetAttribute(k7_rows_kernel<NF, R, SM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned int)((3 * a->TJ + a->TF + a->TG + R - 1) / R), (unsigned int)a->W);
  k7_rows_kernel<NF, R, SM><<<grid, K7A_THREADS, smem, (cudaStream_t)stream>>>(
      *a, pd, part, t_first, npart);
  return (int)cudaGetLastError();
}

template <int NF, int R>
static int k7_rows(const AlmArgs* a, float* pd, float* part, int t_first, int npart,
                   void* stream) {
  if (a->S <= 1) return k7_rows_s<NF, R, 1>(a, pd, part, t_first, npart, stream);
  if (a->S <= 2) return k7_rows_s<NF, R, 2>(a, pd, part, t_first, npart, stream);
  if (a->S <= 4) return k7_rows_s<NF, R, 4>(a, pd, part, t_first, npart, stream);
  return k7_rows_s<NF, R, 8>(a, pd, part, t_first, npart, stream);
}

template <int NF, int G>
static int k7_collision(const AlmArgs* a, const float* pd, float* part, int tile0, int npart,
                        int RB, void* stream) {
  dim3 grid((unsigned int)((a->K + RB - 1) / RB), (unsigned int)a->W);
  switch (RB) {
    case 128:
      k7_collision_kernel<NF, G, 128><<<grid, 128, 0, (cudaStream_t)stream>>>(*a, pd, part, tile0,
                                                                              npart);
      break;
    case 64:
      k7_collision_kernel<NF, G, 64><<<grid, 64, 0, (cudaStream_t)stream>>>(*a, pd, part, tile0,
                                                                            npart);
      break;
    case 32:
      k7_collision_kernel<NF, G, 32><<<grid, 32, 0, (cudaStream_t)stream>>>(*a, pd, part, tile0,
                                                                            npart);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int NF>
static int k7_launch_nf(const AlmArgs* a, float* pd, float* part, int R, int RB, void* stream) {
  const int NR = 3 * a->TJ + a->TF + a->TG;
  const int tiles_a = (NR + R - 1) / R, t_first = 3 * a->TJ / R;
  const int tiles_b = (a->K + RB - 1) / RB;
  const int npart = tiles_a - t_first + tiles_b;
  int err;
  switch (R) {
    case 64: err = k7_rows<NF, 64>(a, pd, part, t_first, npart, stream); break;
    case 32: err = k7_rows<NF, 32>(a, pd, part, t_first, npart, stream); break;
    case 16: err = k7_rows<NF, 16>(a, pd, part, t_first, npart, stream); break;
    case 8: err = k7_rows<NF, 8>(a, pd, part, t_first, npart, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err) return err;
  if (a->K > 0) {
    const int tile0 = tiles_a - t_first;
    if (a->S <= 1) err = k7_collision<NF, 1>(a, pd, part, tile0, npart, RB, stream);
    else if (a->S <= 2) err = k7_collision<NF, 2>(a, pd, part, tile0, npart, RB, stream);
    else if (a->S <= 4) err = k7_collision<NF, 4>(a, pd, part, tile0, npart, RB, stream);
    else err = k7_collision<NF, 8>(a, pd, part, tile0, npart, RB, stream);
    if (err) return err;
  }
  dim3 grid((unsigned int)a->S, (unsigned int)a->W);
  k7_finish_kernel<NF><<<grid, K7C_THREADS, 0, (cudaStream_t)stream>>>(*a, part, npart);
  return (int)cudaGetLastError();
}

// pd: scratch [W, S, 3 TJ, 1 + F]; part: scratch [W, npart, S, NACC] with
// npart = tiles_a - floor(3 TJ / R) + ceil(K / RB); R: polynomial rows per
// CTA of (a) (8, 16, 32, 64); RB: screened rows per CTA of (b) (32, 64,
// 128); 1 <= S <= 8 (the query count Q equals S).
extern "C" int k7_launch(const AlmArgs* a, float* pd, float* part, int R, int RB, void* stream) {
  if (a->S < 1 || a->S > K7_MAXS || a->Q != a->S) return (int)cudaErrorInvalidValue;
  if (a->epi.phase != ALM_EPI_NONE &&
      (a->epi.phase != ALM_EPI_LADDER || a->epi.A < 1 || a->S * a->epi.A > K14_MAX_A))
    return (int)cudaErrorInvalidValue;
  switch (a->F) {
    case 6: return k7_launch_nf<6>(a, pd, part, R, RB, stream);
    case 7: return k7_launch_nf<7>(a, pd, part, R, RB, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
