// K8: ALM merit and feasibility of query points, rows to values.
//
// Replaces the constraint_stack value passes of armour_tpu/nlp.py:494-516
// (the line search, track_best), :517-532 (the multiplier update), :536-543
// (cull_score) and :553-580 (the pull-in bisection and the finalize checks),
// with phi (pz/basis.py:56), the link centres (collision.py:133) and the
// screened collision rows (collision.py:255).  Plain version:
// nlp.py:alm_values_plain.  Per (world, query q) with seed s = seed[q]:
//
//   c = clip(stack(k_q), -1e6)
//   merit = cost(k_q) + sum_r [lam_s + rho_s c > 0] (lam_s + rho_s c)^2 / (2 rho_s)
//   feas = all(c <= thr);  cost(k_q) and c written when asked
//
// The max mode (maxima set; nlp.py:max_violations, armour_tpu/nlp.py:258-297)
// writes instead, per query, vmax = (max_r |u_r| - hi_r over the torque rows,
// the max of the 8 F state rows against the untightened limits, the max of
// the grasp rows; -BIG for a group the plan does not have): the torque
// maximum is the larger of K8's two rows +-u - hi, unclipped, so no
// operation is added to u.  Step (a) tiles the torque and grasp rows only
// (the link centres are neither read nor formed, p is not used), step (b)
// does not run, lam, rho and seed are not read, and value, feas and cost
// are not written.
//
// Bound on the H100 (flagship, W = 64, Q = S A = 12): the world's centre
// and torque polynomials and screened rows are read once, ~0.30 GB, ~0.09
// ms at 3.35 TB/s; ~1.2 MFLOP per query, ~0.9 GFLOP, ~0.03 ms at the 33.5 T
// operations/s of separate float32 multiplies and adds (no FMA contraction):
// bound by bytes (c, when written, adds 4 M bytes per query).
//
// Design: parallel over a world's rows, not its queries, so that each row
// is read once per call for all Q <= 16 queries together, and the grid
// fills the card at W = 1 as at W = 64.  Three launches on one stream:
//
//   (a) rows: a CTA per (tile of R polynomial rows, world).  It stages its
//       R centre / torque rows (cp.async, 16 bytes a lane) and, while they
//       arrive, phi of every query in shared memory; a thread per (row,
//       query slot) forms the dot
//       products.  Centre rows go to the scratch p [W, Qp, 3, TJ] (8.3 MB
//       at W = 64, Q = 12: it stays in L2); torque rows become their two
//       clipped stack rows, whose penalty and violation count are summed
//       per (tile, query) in row order.
//   (b) collision: a CTA per (128 screened rows, group of G queries,
//       world); a thread per row reads its 3 C normals, d and delta once
//       and evaluates K4's rule (alm_collision) at the row's cell for its
//       G queries; per (tile, query) partials by a fixed shuffle tree.
//   (c) finish: a CTA per world sums the partials in tile order, adds the
//       state rows (alm_state_rows) and the cost (alm_cost), and writes
//       value, feas and the cost.
//
// When AlmArgs.epi names a phase of the solve loop (K14, alm_loop.cuh),
// the finish runs it for its world after the queries are reduced, a thread
// per seed reading the queries' merit, feas and cost from shared memory:
// init, accept, outer, the pull-in's start, steps and end, finish.  The
// outer update of the multipliers, lam = max(lam + rho c, 0), runs where
// each clipped row c is formed (in (a), (b) and the finish's state rows),
// from the lam + rho c the merit forms anyway: no scratch c is written or
// read back, and the [W, S, M] multipliers are written once.
//
// R and G come from kernels/solver.py:k8_geometry (the largest tile, the
// widest query group, that still give >= 2 x 132 CTAs).  No atomics: every
// sum has a fixed order, so repeated calls give the same bits.
#include "alm_rows.cuh"

#define K8_MAXQ 16
#define K8A_THREADS 256
#define K8B_THREADS 128
#define K8C_THREADS 128

// One clipped stack row: adds its penalty term and violation to (pen, cnt)
// and returns the clipped value.
__device__ __forceinline__ float k8_row(float c_raw, float lam, float rho, float thr, float& pen,
                                        float& cnt) {
  const float c = alm_clip(c_raw);
  const float z = lam + rho * c;
  pen += z > 0.0f ? z * z : 0.0f;
  cnt += (c <= thr) ? 0.0f : 1.0f;
  return c;
}

// (a) polynomial rows: [0, 3 TJ) link centres, [3 TJ, 3 TJ + TF) torques,
// [3 TJ + TF, 3 TJ + TF + TG) grasp rows; tile t holds rows [row0 + t R,
// row0 + t R + R) (row0 = 3 TJ in the max mode, where (pen, cnt) hold the
// torque and the grasp rows' maxima)
template <int NF, int R>
__global__ void __launch_bounds__(K8A_THREADS) k8_rows_kernel(const AlmArgs a, float* p, int Qp,
                                                             float* part, int ntiles, int row0) {
  constexpr int SLOTS = K8A_THREADS / R;
  constexpr int QPT = (K8_MAXQ + SLOTS - 1) / SLOTS;
  extern __shared__ float4 k8_smem[];
  const int P = alm_pitch(a.B);
  float* kq = (float*)k8_smem;                 // [MAXQ][8]
  float* phi = kq + 8 * K8_MAXQ;               // [MAXQ][P]
  float* tile = phi + K8_MAXQ * P;             // [R][P]
  float* pen = tile + R * P;                   // [MAXQ][R]
  float* cnt = pen + K8_MAXQ * R;              // [MAXQ][R]
  unsigned char* degs = (unsigned char*)(cnt + K8_MAXQ * R);   // [B][ALM_MAX_F]
  const int w = blockIdx.y, t = blockIdx.x, tid = threadIdx.x;
  const int Q = a.Q, B = a.B, TJ = a.TJ, TF = a.TF;
  const int NC = 3 * TJ, NT = NC + TF, NR = NT + a.TG, r0 = row0 + t * R;

  // a warp per staged row, lanes along it: 16-byte asynchronous copies
  // when rows are 16-byte aligned (B % 4 == 0), so that phi is formed while
  // the rows arrive
  const bool vec = B % 4 == 0;
  for (int row = tid >> 5; row < R; row += K8A_THREADS / 32) {
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
  for (int i = tid; i < Q * NF; i += K8A_THREADS)
    kq[(i / NF) * 8 + i % NF] = a.k[(long long)w * Q * NF + i];
  for (int i = tid; i < B * ALM_MAX_F; i += K8A_THREADS) degs[i] = a.degs[i];
  __syncthreads();
  for (int i = tid; i < Q * P; i += K8A_THREADS) {
    const int q = i / P, b = i - P * q;
    float take[NF];
    phi[i] = b < B ? alm_phi<NF>(degs + b * ALM_MAX_F, kq + q * 8, take) : 0.0f;
  }
  alm_cp_wait();
  __syncthreads();

  const int row = tid % R, slot = tid / R, rr = r0 + row;
  float s[QPT];
#pragma unroll
  for (int j = 0; j < QPT; ++j) s[j] = 0.0f;
  const float4* x4 = (const float4*)(tile + row * P);
  for (int b4 = 0; b4 < P / 4; ++b4) {
    const float4 x = x4[b4];
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
      const int q = slot + j * SLOTS;
      if (q < Q) {
        const float4 f = ((const float4*)(phi + q * P))[b4];
        s[j] += x.x * f.x;
        s[j] += x.y * f.y;
        s[j] += x.z * f.z;
        s[j] += x.w * f.w;
      }
    }
  }
  const bool maxima = a.maxima != 0;
#pragma unroll
  for (int j = 0; j < QPT; ++j) {
    const int q = slot + j * SLOTS;
    if (q >= K8_MAXQ) continue;
    // max mode: pe holds the torque rows' maximum, co the grasp rows' (-inf
    // is their identity)
    float pe = maxima ? -INFINITY : 0.0f, co = maxima ? -INFINITY : 0.0f;
    if (q < Q && rr < NC) {
      p[((long long)(w * Qp + q) * 3 + rr % 3) * TJ + rr / 3] = s[j];
    } else if (q < Q && rr < NT && maxima) {
      const float hi = a.u_hi[(long long)w * TF + rr - NC];
      pe = alm_max(s[j] - hi, -s[j] - hi);
    } else if (q < Q && rr < NR && maxima) {
      co = s[j] + a.g_rad[(long long)w * a.TG + rr - NT];
    } else if (q < Q && rr >= NT && rr < NR) {
      const int r = rr - NT, sd = a.seed[q];
      const long long at = ((long long)w * a.S + sd) * a.M + 2 * TF + r;
      const float rho = a.rho[(long long)w * a.S + sd];
      const float c1 = k8_row(s[j] + a.g_rad[(long long)w * a.TG + r], a.lam[at], rho,
                              a.thr_grasp, pe, co);
      if (a.c != nullptr) a.c[((long long)w * Q + q) * a.M + 2 * TF + r] = c1;
      alm_epi_lam(a.epi, at, a.lam[at], rho, c1);
    } else if (q < Q && rr < NR) {
      const int r = rr - NC, sd = a.seed[q];
      const float* lam = a.lam + ((long long)w * a.S + sd) * a.M;
      const float rho = a.rho[(long long)w * a.S + sd];
      const float hi = a.u_hi[(long long)w * TF + r];
      const float c1 = k8_row(s[j] - hi, lam[r], rho, a.thr_torque, pe, co);
      const float c2 = k8_row(-s[j] - hi, lam[TF + r], rho, a.thr_torque, pe, co);
      if (a.c != nullptr) {
        float* cq = a.c + ((long long)w * Q + q) * a.M;
        cq[r] = c1;
        cq[TF + r] = c2;
      }
      const long long at = ((long long)w * a.S + sd) * a.M;
      alm_epi_lam(a.epi, at + r, lam[r], rho, c1);
      alm_epi_lam(a.epi, at + TF + r, lam[TF + r], rho, c2);
    }
    pen[q * R + row] = pe;
    cnt[q * R + row] = co;
  }
  __syncthreads();
  // per query: chunks of 8 rows (a thread each), then the chunk sums in order
  constexpr int NCH = (R + 7) / 8;
  float* chunk = tile;                         // the staged rows are no longer read
  if (tid < K8_MAXQ * NCH) {
    const int q = tid / NCH, ch = tid - NCH * q, r1 = min(R, 8 * ch + 8);
    float pe = pen[q * R + 8 * ch], co = cnt[q * R + 8 * ch];
    for (int i = 8 * ch + 1; i < r1; ++i) {
      pe = maxima ? alm_max(pe, pen[q * R + i]) : pe + pen[q * R + i];
      co = maxima ? alm_max(co, cnt[q * R + i]) : co + cnt[q * R + i];
    }
    chunk[tid * 2] = pe;
    chunk[tid * 2 + 1] = co;
  }
  __syncthreads();
  if (tid < Q) {
    float pe = chunk[tid * NCH * 2], co = chunk[tid * NCH * 2 + 1];
    for (int ch = 1; ch < NCH; ++ch) {
      pe = maxima ? alm_max(pe, chunk[(tid * NCH + ch) * 2]) : pe + chunk[(tid * NCH + ch) * 2];
      co = maxima ? alm_max(co, chunk[(tid * NCH + ch) * 2 + 1])
                  : co + chunk[(tid * NCH + ch) * 2 + 1];
    }
    float* o = part + (((long long)w * ntiles + t) * Q + tid) * 2;
    o[0] = pe;
    o[1] = co;
  }
}

// (b) screened collision rows, G queries per thread
template <int G>
__global__ void __launch_bounds__(K8B_THREADS) k8_collision_kernel(const AlmArgs a, const float* p,
                                                                  int Qp, float* part, int tile0,
                                                                  int ntiles) {
  __shared__ float red[(K8B_THREADS / 32) * 2 * G];
  const int w = blockIdx.z, q0 = blockIdx.y * G, r = blockIdx.x * K8B_THREADS + threadIdx.x;
  const int Q = a.Q, K = a.K, nq = min(G, Q - q0);
  float acc[2 * G];
#pragma unroll
  for (int g = 0; g < 2 * G; ++g) acc[g] = 0.0f;
  if (r < K) {
    float m[G];
    // queries q0 + g >= Q read the scratch's padding; their results are dropped
    alm_collision<G>(a, w, r, p + (long long)(w * Qp + q0) * 3 * a.TJ, m, nullptr, nullptr);
    const bool real = a.mask[(long long)w * K + r] != 0;
    const int row = 2 * a.TF + a.TG + r;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= nq) continue;
      const int q = q0 + g, sd = a.seed[q];
      const float gval = real ? -m[g] : -ALM_BIG;
      const long long at = ((long long)w * a.S + sd) * a.M + row;
      const float rho = a.rho[(long long)w * a.S + sd];
      const float c = k8_row(gval + a.col_margin, a.lam[at], rho, a.thr_col, acc[2 * g],
                             acc[2 * g + 1]);
      if (a.c != nullptr) a.c[((long long)w * Q + q) * a.M + row] = c;
      alm_epi_lam(a.epi, at, a.lam[at], rho, c);
    }
  }
  alm_block_sum<2 * G, K8B_THREADS / 32>(acc, red);
  if (threadIdx.x != 0) return;
  for (int g = 0; g < nq; ++g) {
    float* o = part + (((long long)w * ntiles + tile0 + blockIdx.x) * Q + q0 + g) * 2;
    o[0] = acc[2 * g];
    o[1] = acc[2 * g + 1];
  }
}

// The solve loop's phase of seed s of world w after K8's queries (AlmArgs.epi;
// alm_loop.cuh): merit, feas and cost of the world's Q queries as written
// to memory.  The ladder's accept reads the seed's A queries s A ..; every
// other phase one query per seed, query s (the launcher checks Q).
template <int NF>
__device__ __forceinline__ void k8_epilogue(const AlmArgs& a, int w, int s, const float* merit,
                                            const unsigned char* feas, const float* cost) {
  const AlmEpilogue& e = a.epi;
  const long long i = (long long)w * a.S + s;
  const float* kq = a.k + (long long)w * a.Q * NF;
  const float* ks = kq + s * NF;
  const bool ok = feas[s] != 0;
  switch (e.phase) {
    case ALM_EPI_INIT: alm_epi_init(e, i, ks, ok, cost[s], NF); break;
    case ALM_EPI_ACCEPT: alm_epi_accept(e, i, s, kq, merit, feas, cost, NF); break;
    case ALM_EPI_OUTER: alm_epi_outer(e, i, ks, ok, cost[s], a.rho[i], NF); break;
    case ALM_EPI_PULL_START: alm_epi_pull_start(e, i, ks, NF); break;
    case ALM_EPI_PULL_STEP: alm_epi_pull_step(e, i, ks, ok, NF); break;
    case ALM_EPI_PULL_END: alm_epi_pull_end(e, i, ks, ok, NF); break;
    case ALM_EPI_FINISH: alm_epi_finish(e, w, s, a.S, ks, ok, cost[s], NF); break;
    default: break;
  }
}

// (c) the finish: partials in tile order, then the state rows and the cost;
// in the max mode the torque and grasp maxima of the nread row tiles and
// the state rows' maximum
template <int NF>
__global__ void __launch_bounds__(K8C_THREADS) k8_finish_kernel(const AlmArgs a, const float* part,
                                                               int ntiles, int nread) {
  __shared__ float st[K8_MAXQ * NF * 2];
  const int w = blockIdx.x, tid = threadIdx.x, Q = a.Q;
  if (a.maxima) {
    if (tid < Q * NF) {
      const int q = tid / NF, f = tid % NF;
      float c8[8], j8[8];
      alm_state_rows(a, a.limits + 3 * NF, w, f, a.k[((long long)w * Q + q) * NF + f], c8, j8);
      float m = c8[0];
      for (int grp = 1; grp < 8; ++grp) m = alm_max(m, c8[grp]);
      st[tid] = m;
    }
    __syncthreads();
    if (tid >= Q) return;
    const float* pq = part + ((long long)w * ntiles * Q + tid) * 2;
    float vt = -ALM_BIG, vg = -ALM_BIG;   // without torque / grasp rows
    if (nread > 0) {
      float mt = pq[0], mg = pq[1];
      for (int t = 1; t < nread; ++t) {
        mt = alm_max(mt, pq[(long long)t * Q * 2]);
        mg = alm_max(mg, pq[(long long)t * Q * 2 + 1]);
      }
      if (a.TF > 0) vt = mt;
      if (a.TG > 0) vg = mg;
    }
    float vs = st[tid * NF];
    for (int f = 1; f < NF; ++f) vs = alm_max(vs, st[tid * NF + f]);
    float* o = a.vmax + ((long long)w * Q + tid) * 3;
    o[0] = vt;
    o[1] = vs;
    o[2] = vg;
    return;
  }
  if (tid < Q * NF) {
    const int q = tid / NF, f = tid % NF, sd = a.seed[q];
    const float* lam = a.lam + ((long long)w * a.S + sd) * a.M;
    const float rho = a.rho[(long long)w * a.S + sd];
    float c8[8], j8[8], pe = 0.0f, co = 0.0f;
    alm_state_rows(a, a.limits, w, f, a.k[((long long)w * Q + q) * NF + f], c8, j8);
    for (int grp = 0; grp < 8; ++grp) {
      const int row = 2 * a.TF + a.TG + a.K + grp * NF + f;
      const float c = k8_row(c8[grp], lam[row], rho, a.thr_state, pe, co);
      if (a.c != nullptr) a.c[((long long)w * Q + q) * a.M + row] = c;
      alm_epi_lam(a.epi, ((long long)w * a.S + sd) * a.M + row, lam[row], rho, c);
    }
    st[tid * 2] = pe;
    st[tid * 2 + 1] = co;
  }
  __syncthreads();
  __shared__ float q_merit[K8_MAXQ], q_cost[K8_MAXQ];
  __shared__ unsigned char q_feas[K8_MAXQ];
  if (tid < Q) {
    const int q = tid;
    const float* pq = part + ((long long)w * ntiles * Q + q) * 2;
    float pe = pq[0], co = pq[1];
#pragma unroll 8
    for (int t = 1; t < nread; ++t) {
      pe += pq[(long long)t * Q * 2];
      co += pq[(long long)t * Q * 2 + 1];
    }
    float kk[NF];
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      pe += st[(q * NF + f) * 2];
      co += st[(q * NF + f) * 2 + 1];
      kk[f] = a.k[((long long)w * Q + q) * NF + f];
    }
    const float rho = a.rho[(long long)w * a.S + a.seed[q]];
    const long long o = (long long)w * Q + q;
    const float cost = alm_cost(a, w, kk, nullptr);
    const float merit = cost + pe / (2.0f * rho);
    const unsigned char feas = co == 0.0f ? 1 : 0;
    a.value[o] = merit;
    a.feas[o] = feas;
    if (a.cost != nullptr) a.cost[o] = cost;
    q_merit[q] = merit;
    q_feas[q] = feas;
    q_cost[q] = cost;
  }
  if (a.epi.phase == ALM_EPI_NONE) return;
  // the solve loop's phase on this world's queries, a thread per seed
  __syncthreads();
  if (tid < a.S) k8_epilogue<NF>(a, w, tid, q_merit, q_feas, q_cost);
}

static size_t k8_rows_smem(int B, int R) {
  const int P = alm_pitch(B);
  return sizeof(float) * (8 * K8_MAXQ + (size_t)K8_MAXQ * P + (size_t)R * P + 2 * K8_MAXQ * R)
         + (size_t)B * ALM_MAX_F;
}

template <int NF, int R>
static int k8_rows(const AlmArgs* a, float* p, int Qp, float* part, int tiles, int ntiles,
                   int row0, void* stream) {
  const size_t smem = k8_rows_smem(a->B, R);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(k8_rows_kernel<NF, R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned int)tiles, (unsigned int)a->W);
  k8_rows_kernel<NF, R><<<grid, K8A_THREADS, smem, (cudaStream_t)stream>>>(*a, p, Qp, part, ntiles,
                                                                          row0);
  return (int)cudaGetLastError();
}

template <int G>
static int k8_collision(const AlmArgs* a, const float* p, int Qp, float* part, int tile0,
                        int ntiles, void* stream) {
  dim3 grid((unsigned int)((a->K + K8B_THREADS - 1) / K8B_THREADS),
            (unsigned int)((a->Q + G - 1) / G), (unsigned int)a->W);
  k8_collision_kernel<G><<<grid, K8B_THREADS, 0, (cudaStream_t)stream>>>(*a, p, Qp, part, tile0,
                                                                         ntiles);
  return (int)cudaGetLastError();
}

template <int NF>
static int k8_launch_nf(const AlmArgs* a, float* p, float* part, int R, int G, void* stream) {
  const int Qp = (a->Q + G - 1) / G * G;
  const int row0 = a->maxima ? 3 * a->TJ : 0;
  const int tiles_a = (3 * a->TJ + a->TF + a->TG - row0 + R - 1) / R;
  const int ntiles = a->maxima ? tiles_a : tiles_a + (a->K + K8B_THREADS - 1) / K8B_THREADS;
  int err = 0;
  if (tiles_a > 0) {
    switch (R) {
      case 64: err = k8_rows<NF, 64>(a, p, Qp, part, tiles_a, ntiles, row0, stream); break;
      case 32: err = k8_rows<NF, 32>(a, p, Qp, part, tiles_a, ntiles, row0, stream); break;
      case 16: err = k8_rows<NF, 16>(a, p, Qp, part, tiles_a, ntiles, row0, stream); break;
      case 8: err = k8_rows<NF, 8>(a, p, Qp, part, tiles_a, ntiles, row0, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (err) return err;
  if (a->K > 0 && !a->maxima) {
    switch (G) {
      case 16: err = k8_collision<16>(a, p, Qp, part, tiles_a, ntiles, stream); break;
      case 12: err = k8_collision<12>(a, p, Qp, part, tiles_a, ntiles, stream); break;
      case 8: err = k8_collision<8>(a, p, Qp, part, tiles_a, ntiles, stream); break;
      case 6: err = k8_collision<6>(a, p, Qp, part, tiles_a, ntiles, stream); break;
      case 4: err = k8_collision<4>(a, p, Qp, part, tiles_a, ntiles, stream); break;
      case 2: err = k8_collision<2>(a, p, Qp, part, tiles_a, ntiles, stream); break;
      case 1: err = k8_collision<1>(a, p, Qp, part, tiles_a, ntiles, stream); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (err) return err;
  }
  k8_finish_kernel<NF><<<(unsigned int)a->W, K8C_THREADS, 0, (cudaStream_t)stream>>>(
      *a, part, ntiles, a->maxima ? tiles_a : ntiles);
  return (int)cudaGetLastError();
}

// p: scratch [W, Qp, 3, TJ] (Qp = Q rounded up to G; null in the max mode);
// part: scratch [W, ntiles, Q, 2] (max mode: ntiles = the torque and grasp
// rows' tiles); R: polynomial rows per CTA (8, 16, 32, 64); G: queries per
// collision thread (1, 2, 4, 6, 8, 12, 16); Q <= 16.
extern "C" int k8_launch(const AlmArgs* a, float* p, float* part, int R, int G, void* stream) {
  if (a->Q > K8_MAXQ) return (int)cudaErrorInvalidValue;
  const int ph = a->epi.phase;
  if (ph != ALM_EPI_NONE) {
    // a phase of the loop: not in the max mode, seeds and queries as it reads them
    const int per = ph == ALM_EPI_ACCEPT ? a->epi.A : 1;
    if (a->maxima || ph == ALM_EPI_LADDER || ph < 0 || ph > ALM_EPI_FINISH || a->S < 1 ||
        a->S > K14_MAX_S || per < 1 || a->Q != a->S * per)
      return (int)cudaErrorInvalidValue;
  }
  switch (a->F) {
    case 6: return k8_launch_nf<6>(a, p, part, R, G, stream);
    case 7: return k8_launch_nf<7>(a, p, part, R, G, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
