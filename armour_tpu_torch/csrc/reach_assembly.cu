// K15: the reach sets' assembly after the chain kernels, in one launch.
//
// Replaces the XLA-fused ops armour_tpu/dynamics.py:293 torque_frs (the
// assembly after the RNEA) and armour_tpu/kinematics.py:115 reduce_links;
// their plain PyTorch versions are dynamics.torque_assembly_plain and
// kinematics.reduce_links_plain (together dynamics.reach_assembly_plain).
// Per (world, time step) it does both jobs:
//   torque (from K10's u_both [W, 2, T, F, .], nominal then interval): per
//     factor f the disturbance u_int - u_nom's interval hull (centre, radius
//     = sum_m>0 |coef_m| + sum_e |egen_e| + rad), d_max = max(|lo|, |hi|),
//     rho = sqrt(sum_f max(lo^2, hi^2)), the nominal radius rad + sum_e
//     |egen_e| and torque_radius = c0 + d_max / 2 + rho / 2 + nominal radius
//     + friction_f; u_coef stays a view of K10's output;
//   links (from K9's links [W, T, J, 3, .]): per (link, axis) the shape
//     generators (the egen slots [sh0, sh0 + 3)) and radius = rad + sum of
//     |egen| over the other slots.
//
// Every sum runs left to right in one thread, as the plain version sums
// (utils.abs_sum_in_order): torch's CUDA sum order is its own, and the
// bits of the radii decide the screen's rows and the solver's steps.  c0
// and the friction are the plain version's Python doubles rounded once to
// float32.  Built without fast math and with -fmad=false; sqrtf is IEEE.
//
// Bound on the H100 (W = 64, T = 128, F = J = 7, B = 120, E = 38): it reads
// u_both (73 MB) and the links' egen and rad (27 MB) once and writes 2.5
// MB: ~0.03 ms at 3.35 TB/s; ~0.4 float32 operations a byte.  So the design
// keeps enough bytes in flight and never waits on them:
//   - a tile is K15_TILE consecutive time steps of one world: its u_both
//     planes, the links' rows and both radii are eight contiguous ranges
//     (u_both's (w, p) planes and the links are contiguous along t);
//   - a persistent grid of as many blocks as fit an SM's shared memory
//     (kernels/reach.py:k15_geometry, two at the flagship widths) walks the
//     tiles; each block copies its next tile with 16-byte cp.async into a
//     two-stage ring while it sums the current one;
//   - a warp takes one step of the tile, and its lanes the sums: F lanes
//     the long disturbance sums over coef (B - 1 terms, 16-byte loads), F
//     lanes the disturbance's and the nominal egen sums side by side (ne
//     read once), every lane a link row; the disturbance's two sums were
//     always separate chains, so the bits stay.  The sums' shared-memory
//     loads compete with the copies landing there (on an H100 the copies
//     alone ran at 2.6 TB/s, and scalar sums a lane per row, with bank
//     conflicts, nearly doubled the kernel's time), so they are few;
//   - the ring puts each range at the phase (offset mod 4 floats) it has in
//     its tensor, so any T and any ragged last tile copy 16 bytes at a time
//     between a 4-byte head and tail; hence the bases must be 16-byte
//     aligned (the wrapper raises otherwise).
#include <cuda_runtime.h>

#include "ring_copy.cuh"

#define K15_TILE 4                    // time steps a tile: a warp each
#define K15_THREADS (32 * K15_TILE)
#define K15_STAGES 2
#define K15_MAXF 8
#define K15_MAXJ3 27
#define K15_RANGES 8                  // coef, egen, rad of both planes; links' egen, rad
#define K15_PART 5                    // per warp and factor: s1, s2, nominal sum, d_max, sq

struct K15Args {
  const float* uc;        // [W, 2, T, F, B] u_both coefficients
  const float* ue;        // [W, 2, T, F, E]
  const float* ur;        // [W, 2, T, F]
  const float* le;        // [W, T, J3, E] the links' egen
  const float* lr;        // [W, T, J3]
  float* torque_radius;   // [W, T, F]
  float* shape_gens;      // [W, T, J3, 3]
  float* radius;          // [W, T, J3]
  int W, T, F, J3, B, E;
  int sh0;                // the first shape slot of the egen block
  float c0;               // ub.alpha (ub.m_max - ub.m_min) ub.eps
  float friction[K15_MAXF];
};

// floats a step of range r holds (K15_RANGES order)
static __host__ __device__ __forceinline__ int k15_count(const K15Args& a, int r) {
  switch (r) {
    case 0: case 1: return a.F * a.B;
    case 2: case 3: return a.F * a.E;
    case 4: case 5: return a.F;
    case 6: return a.J3 * a.E;
    default: return a.J3;
  }
}

// floats of one range's ring slot: a tile and 3 floats of phase, a multiple of 4
static __host__ __device__ __forceinline__ int k15_slot(const K15Args& a, int r) {
  return (K15_TILE * k15_count(a, r) + 3 + 3) / 4 * 4;
}

static __host__ __device__ __forceinline__ int k15_stage_floats(const K15Args& a) {
  int n = 0;
  for (int r = 0; r < K15_RANGES; ++r) n += k15_slot(a, r);
  return n;
}

// bytes of dynamic shared memory of a block: the ring, then the warps' parts
static __host__ __device__ __forceinline__ size_t k15_smem(const K15Args& a) {
  return sizeof(float) * ((size_t)K15_STAGES * k15_stage_floats(a) +
                          K15_TILE * K15_PART * K15_MAXF);
}

// NaN-propagating max (torch.maximum)
__device__ __forceinline__ float k15_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

// The global start (offset in floats from its base) of range r of tile
// (w, t0): u_both's plane p = r & 1 of coef / egen / rad, or the links'.
__device__ __forceinline__ long long k15_offset(const K15Args& a, int r, long long w, int t0) {
  const long long row = r < 6 ? (w * 2 + (r & 1)) * a.T + t0 : w * a.T + t0;
  return row * k15_count(a, r);
}

__device__ __forceinline__ const float* k15_base(const K15Args& a, int r) {
  return r < 2 ? a.uc : r < 4 ? a.ue : r < 6 ? a.ur : r == 6 ? a.le : a.lr;
}

// Start the copies of tile (w, t0) of nv steps into stage `st` (each range
// at its slot, ring_copy).
__device__ __forceinline__ void k15_issue(const K15Args& a, float* st, long long w, int t0,
                                          int nv) {
  for (int r = 0; r < K15_RANGES; ++r) {
    ring_copy(st, k15_base(a, r), k15_offset(a, r, w, t0), nv * k15_count(a, r), K15_THREADS);
    st += k15_slot(a, r);
  }
}

// sum_m>0 |x_m - y_m| over a coefficient row of B floats, left to right
// from 0; 16-byte loads where the rows are 16-byte aligned (B a multiple
// of 4: the coef ranges then start at phase 0)
__device__ __forceinline__ float k15_long_sum(const float* x, const float* y, int B) {
  float s = 0.0f;
  if ((B & 3) == 0) {
    const float4* x4 = (const float4*)x;
    const float4* y4 = (const float4*)y;
    float4 u = x4[0], v = y4[0];
    s = s + fabsf(u.y - v.y);
    s = s + fabsf(u.z - v.z);
    s = s + fabsf(u.w - v.w);
#pragma unroll 4
    for (int q = 1; q < B / 4; ++q) {
      u = x4[q];
      v = y4[q];
      s = s + fabsf(u.x - v.x);
      s = s + fabsf(u.y - v.y);
      s = s + fabsf(u.z - v.z);
      s = s + fabsf(u.w - v.w);
    }
  } else {
#pragma unroll 8
    for (int m = 1; m < B; ++m) s = s + fabsf(x[m] - y[m]);
  }
  return s;
}

__global__ void __launch_bounds__(K15_THREADS) k15_kernel(const __grid_constant__ K15Args a) {
  extern __shared__ __align__(16) float k15_smem_f[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int F = a.F, B = a.B, E = a.E, J3 = a.J3, T = a.T;
  const int stage = k15_stage_floats(a);
  float* part = k15_smem_f + K15_STAGES * stage + warp * K15_PART * K15_MAXF;
  const int per_world = (T + K15_TILE - 1) / K15_TILE;
  const long long tiles = (long long)a.W * per_world;

  // the ring: tile i of this block lands in stage i mod K15_STAGES, issued
  // K15_STAGES - 1 tiles ahead of its sums
  long long tile = blockIdx.x;
  for (int j = 0; j < K15_STAGES - 1; ++j) {
    const long long ahead = tile + (long long)j * gridDim.x;
    if (ahead < tiles) {
      const long long w = ahead / per_world;
      const int t0 = (int)(ahead - w * per_world) * K15_TILE;
      k15_issue(a, k15_smem_f + j * stage, w, t0, min(K15_TILE, T - t0));
    }
    ring_commit();
  }
  for (int i = 0; tile < tiles; ++i, tile += gridDim.x) {
    const long long ahead = tile + (long long)(K15_STAGES - 1) * gridDim.x;
    if (ahead < tiles) {
      const long long w = ahead / per_world;
      const int t0 = (int)(ahead - w * per_world) * K15_TILE;
      k15_issue(a, k15_smem_f + ((i + K15_STAGES - 1) % K15_STAGES) * stage, w, t0,
                min(K15_TILE, T - t0));
    }
    ring_commit();
    ring_wait<K15_STAGES - 1>();
    __syncthreads();

    const long long w = tile / per_world;
    const int t0 = (int)(tile - w * per_world) * K15_TILE, s = warp;
    if (t0 + s < T) {
      // the ranges of this tile in the stage, each at its phase
      const float* r0 = k15_smem_f + (i % K15_STAGES) * stage;
      const float* rng[K15_RANGES];
      for (int r = 0; r < K15_RANGES; ++r) {
        rng[r] = r0 + (k15_offset(a, r, w, t0) & 3);
        r0 += k15_slot(a, r);
      }
      const float* nc = rng[0] + s * F * B;   // step s's rows
      const float* ic = rng[1] + s * F * B;
      const float* ne = rng[2] + s * F * E;
      const float* ie = rng[3] + s * F * E;
      const float* nr = rng[4] + s * F;
      const float* ir = rng[5] + s * F;
      const float* le = rng[6] + s * J3 * E;
      const float* lr = rng[7] + s * J3;
      const long long wt = w * T + t0 + s;
      // lane f < F: factor f's long disturbance sum over coef (B - 1
      // terms); lane F + f: its disturbance's and its nominal egen sums
      // side by side (E terms, ne read once); then the J3 link rows, row p
      // by lane (2F + p) mod 32 (2F + J3 <= 64), after those sums
      if (lane < F) {
        part[lane] = k15_long_sum(ic + lane * B, nc + lane * B, B);
      } else if (lane < 2 * F) {
        const int f = lane - F;
        const float* x = ie + f * E;
        const float* y = ne + f * E;
        float s2 = 0.0f, sn = 0.0f;
#pragma unroll 8
        for (int e = 0; e < E; ++e) {
          const float u = x[e], v = y[e];
          s2 = s2 + fabsf(u - v);
          sn = sn + fabsf(v);
        }
        part[K15_MAXF + f] = s2;
        part[2 * K15_MAXF + f] = nr[f] + sn;
      }
      for (int p = lane >= 2 * F ? lane - 2 * F : lane + 32 - 2 * F; p < J3; p += 32) {
        const float* x = le + p * E;
        float sl = 0.0f;
#pragma unroll 8
        for (int e = 0; e < a.sh0; ++e) sl = sl + fabsf(x[e]);
#pragma unroll 8
        for (int e = a.sh0 + 3; e < E; ++e) sl = sl + fabsf(x[e]);
        a.radius[wt * J3 + p] = lr[p] + sl;
      }
      __syncwarp();
      if (lane < F) {                         // the disturbance's hull of factor f
        const int f = lane;
        const float dr = (part[f] + part[K15_MAXF + f]) + (ir[f] + nr[f]);
        const float dc = ic[f * B] - nc[f * B];
        const float lo = dc - dr, hi = dc + dr;
        part[3 * K15_MAXF + f] = k15_max(fabsf(lo), fabsf(hi));
        part[4 * K15_MAXF + f] = k15_max(lo * lo, hi * hi);
      }
      __syncwarp();
      if (lane < F) {
        float rho_sq = part[4 * K15_MAXF];
        for (int f = 1; f < F; ++f) rho_sq = rho_sq + part[4 * K15_MAXF + f];
        const float rho = sqrtf(rho_sq);
        a.torque_radius[wt * F + lane] =
            (((a.c0 + 0.5f * part[3 * K15_MAXF + lane]) + 0.5f * rho) +
             part[2 * K15_MAXF + lane]) + a.friction[lane];
      }
      for (int x = lane; x < J3 * 3; x += 32)
        a.shape_gens[wt * J3 * 3 + x] = le[(x / 3) * E + a.sh0 + x % 3];
      __syncwarp();   // the next tile's parts overwrite this one's only after these reads
    }
    __syncthreads();  // the stage is free for the copies issued in iteration i + 1
  }
}

// the persistent grid of `grid` blocks over the W ceil(T / K15_TILE) tiles
extern "C" int k15_launch(const K15Args* args, int grid, void* stream) {
  if (grid < 1 || args->F < 1 || args->F > K15_MAXF || args->J3 > K15_MAXJ3 ||
      args->sh0 < 0 || args->sh0 + 3 > args->E || 2 * args->F + args->J3 > 64)
    return (int)cudaErrorInvalidValue;
  const size_t smem = k15_smem(*args);
  const cudaError_t err = cudaFuncSetAttribute(
      k15_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  k15_kernel<<<(unsigned int)grid, K15_THREADS, smem, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
