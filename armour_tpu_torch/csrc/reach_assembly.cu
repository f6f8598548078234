// K15: the reach sets' assembly after the chain kernels, in one launch.
//
// Replaces the XLA-fused ops armour_tpu/dynamics.py:293 torque_frs (the
// assembly after the RNEA) and armour_tpu/kinematics.py:115 reduce_links;
// their plain PyTorch versions are dynamics.torque_assembly_plain and
// kinematics.reduce_links_plain (together dynamics.reach_assembly_plain).
// One block per (world, time step) does both jobs:
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
// MB: ~0.03 ms at 3.35 TB/s; ~0.4 float32 operations a byte.  Design: the
// block stages its (world, time) slab of u_both and of the links' egen in
// shared memory with loads coalesced along the slab (12 KB at these
// widths), then warp 0 takes the F disturbance sums (lane f), warp 1 the F
// nominal sums and the 3 J link rows, so that the long and the short sums
// run side by side; the torque radius and the shape generators last.
#include <cuda_runtime.h>

#define K15_THREADS 64
#define K15_MAXF 8
#define K15_MAXJ3 27

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

// NaN-propagating max (torch.maximum)
__device__ __forceinline__ float k15_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

__global__ void __launch_bounds__(K15_THREADS) k15_kernel(const __grid_constant__ K15Args a) {
  extern __shared__ float k15_smem[];
  __shared__ float s_sq[K15_MAXF], s_dmax[K15_MAXF], s_nrad[K15_MAXF];
  const int tid = threadIdx.x;
  const long long wt = blockIdx.x;                      // w T + t
  const long long w = wt / a.T, t = wt - w * a.T;
  const int F = a.F, B = a.B, E = a.E, J3 = a.J3;
  float* s_c = k15_smem;                                // [2, F, B]
  float* s_e = s_c + 2 * F * B;                         // [2, F, E]
  float* s_r = s_e + 2 * F * E;                         // [2, F]
  float* s_l = s_r + 2 * F;                             // [J3, E]
  for (int p = 0; p < 2; ++p) {
    const long long slab = (w * 2 + p) * a.T + t;       // (w, p, t)
    const float* gc = a.uc + slab * F * B;
    for (int i = tid; i < F * B; i += K15_THREADS) s_c[p * F * B + i] = gc[i];
    const float* ge = a.ue + slab * F * E;
    for (int i = tid; i < F * E; i += K15_THREADS) s_e[p * F * E + i] = ge[i];
    if (tid < F) s_r[p * F + tid] = a.ur[slab * F + tid];
  }
  const float* gl = a.le + wt * J3 * E;
  for (int i = tid; i < J3 * E; i += K15_THREADS) s_l[i] = gl[i];
  __syncthreads();

  if (tid < 32) {
    if (tid < F) {                                      // the disturbance of factor f
      const int f = tid;
      const float* nc = s_c + f * B;
      const float* ic = s_c + (F + f) * B;
      float s1 = 0.0f;
      for (int m = 1; m < B; ++m) s1 = s1 + fabsf(ic[m] - nc[m]);
      const float* ne = s_e + f * E;
      const float* ie = s_e + (F + f) * E;
      float s2 = 0.0f;
      for (int e = 0; e < E; ++e) s2 = s2 + fabsf(ie[e] - ne[e]);
      const float dr = (s1 + s2) + (s_r[F + f] + s_r[f]);
      const float dc = ic[0] - nc[0];
      const float lo = dc - dr, hi = dc + dr;
      s_dmax[f] = k15_max(fabsf(lo), fabsf(hi));
      s_sq[f] = k15_max(lo * lo, hi * hi);
    }
  } else {
    // F + J3 <= 35 rows: a second round for lanes 0..2 at J = 9
    for (int r = tid - 32; r < F + J3; r += 32) {
      if (r < F) {                                      // the nominal radius of factor r
        const float* ne = s_e + r * E;
        float s = 0.0f;
        for (int e = 0; e < E; ++e) s = s + fabsf(ne[e]);
        s_nrad[r] = s_r[r] + s;
      } else {                                          // link row l = (j, axis)
        const int l = r - F;
        const float* le = s_l + l * E;
        float s = 0.0f;
        for (int e = 0; e < a.sh0; ++e) s = s + fabsf(le[e]);
        for (int e = a.sh0 + 3; e < E; ++e) s = s + fabsf(le[e]);
        a.radius[wt * J3 + l] = a.lr[wt * J3 + l] + s;
      }
    }
  }
  __syncthreads();

  if (tid < F) {
    float rho_sq = s_sq[0];
    for (int f = 1; f < F; ++f) rho_sq = rho_sq + s_sq[f];
    const float rho = sqrtf(rho_sq);
    a.torque_radius[wt * F + tid] =
        (((a.c0 + 0.5f * s_dmax[tid]) + 0.5f * rho) + s_nrad[tid]) + a.friction[tid];
  }
  for (int i = tid; i < J3 * 3; i += K15_THREADS)
    a.shape_gens[wt * J3 * 3 + i] = s_l[(i / 3) * E + a.sh0 + i % 3];
}

extern "C" int k15_launch(const K15Args* args, int smem_bytes, void* stream) {
  const unsigned int blocks = (unsigned int)((long long)args->W * args->T);
  k15_kernel<<<blocks, K15_THREADS, smem_bytes, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
