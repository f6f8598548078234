// A test reference for K13 (armour_tpu_torch/csrc/screen_collision.cu): the
// collision screen written to read K3's hyperplane tensors.  K13 forms each
// row's hyperplanes again from the cells' inputs with K3's own device code;
// tests/test_torch_jrs_screen_kernels.py builds this file with the port's
// nvcc flags and holds K13 to it, bit for bit, on the same K3 output.  Not
// part of the port.  Three launches on one stream:
//   (a) k13_bound: one thread per (world, row n = (t J + j) O + o): the
//       upper bound of g over the k-box, sup_k g <= -max_c max(+-(A_c . p0)
//       - r_c - (+-d_c + delta_c)), r_c = sum_a |A_ac| env_a (the link
//       centre's constant term p0 and its monomial envelope env of the
//       row's (time, link) cell), -BIG where the normal is zero; -BIG for
//       a padded obstacle's row.  Written to the scratch g [W, N].
//   (b) k13_select: one block per world.  The rows in jax.lax.top_k's
//       order: value descending, the lower index first among equal values
//       (-0.0 taken as +0.0; a NaN ranks first, as in torch.sort).  A row's
//       32-bit key is the order-preserving integer of its value, inverted;
//       a radix select (four 8-bit digits, a shared histogram) finds the
//       k-th smallest key, the rows below it are taken, and of the rows at
//       it the lowest indices (an ordered compaction, a ballot per warp);
//       the k chosen (key, index) pairs are then sorted by a bitonic sort,
//       in shared memory (or in a global scratch when k is large).  With an
//       obstacle quota q: each obstacle's best q rows first, obstacle-major,
//       each taken row's value set to -inf, then the other K - q O rows
//       from all of them (collision.py:screen_rows).
//   (c) k13_gather: one thread per (world, hyperplane c, chosen row):
//       A [W, 3, C, K], d and delta [W, C, K], and per (world, row) the
//       link cell row = n / O (int32) and the real-obstacle mask.
//
// At the flagship widths (W = 64, T = 128, J = 7, O = 40, C = 36, K = 4096)
// pass (a) reads A (991 MB), d and delta (330 MB each), and the gather (c)
// reads ~1 GB of 32-byte sectors to move 0.19 GB.
//
// The float32 arithmetic of (a) repeats the plain version operation by
// operation (_dot3 sums (a0 b0 + a1 b1) + a2 b2); env is the launcher's
// torch.sum, so its reduction order is the plain version's.  Built without
// fast math and with -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

#define K13_BOUND_THREADS 256
#define K13_SELECT_THREADS 1024
#define K13_GATHER_THREADS 256
#define K13_BIG 1e8f

struct K13Args {
  const float* A;              // [W, 3, C, N]
  const float* d;              // [W, C, N]
  const float* delta;          // [W, C, N]
  const float* center;         // [W, T*J, 3, B] link-centre coefficients
  const float* env;            // [W, T*J, 3] sum_b>0 |coef_b|
  const unsigned char* obs_mask;  // [W, O]
  float* g;                    // [W, N] scratch: the upper bound, then -inf where taken
  int* idx;                    // [W, K] the chosen rows
  unsigned long long* sort;    // [W, Kp] sort scratch when it is not in shared memory
  float* A_out;                // [W, 3, C, K]
  float* d_out;                // [W, C, K]
  float* delta_out;            // [W, C, K]
  int* row;                    // [W, K]
  unsigned char* mask;         // [W, K]
  int W, C, N, TJ, O, B, K;
  int quota;                   // rows reserved per obstacle, 0 for none
  int Kp;                      // sort length, a power of two >= K
  int smem_sort;               // 1: the sort buffer is in shared memory
};

// NaN-propagating max (torch.amax / torch.maximum)
__device__ __forceinline__ float k13_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

__global__ void __launch_bounds__(K13_BOUND_THREADS) k13_bound(const __grid_constant__ K13Args a) {
  const int n = blockIdx.x * K13_BOUND_THREADS + threadIdx.x;
  const int w = blockIdx.y;
  if (n >= a.N) return;
  const int tj = n / a.O, o = n - tj * a.O;
  const long long N = a.N, C = a.C;
  const float* cc = a.center + ((long long)w * a.TJ + tj) * 3 * a.B;
  const float p0x = cc[0], p0y = cc[a.B], p0z = cc[2 * a.B];
  const float* en = a.env + ((long long)w * a.TJ + tj) * 3;
  const float e0 = en[0], e1 = en[1], e2 = en[2];
  const float* A0 = a.A + (long long)w * 3 * C * N + n;
  const float* dd = a.d + (long long)w * C * N + n;
  const float* dl = a.delta + (long long)w * C * N + n;
  float mp = 0.0f, mn = 0.0f;
  for (int c = 0; c < a.C; ++c) {
    const float ax = A0[c * N], ay = A0[(C + c) * N], az = A0[(2 * C + c) * N];
    const float d = dd[c * N], del = dl[c * N];
    const float Apc = (ax * p0x + ay * p0y) + az * p0z;
    const float r = (fabsf(ax) * e0 + fabsf(ay) * e1) + fabsf(az) * e2;
    const bool ok = (fabsf(ax) + fabsf(ay)) + fabsf(az) > 0.0f;
    const float pos = ok ? (Apc - r) - (d + del) : -K13_BIG;
    const float neg = ok ? ((-Apc) - r) - ((-d) + del) : -K13_BIG;
    mp = c == 0 ? pos : k13_max(mp, pos);
    mn = c == 0 ? neg : k13_max(mn, neg);
  }
  const float m = k13_max(mp, mn);
  a.g[(long long)w * N + n] = a.obs_mask[(long long)w * a.O + o] ? -m : -K13_BIG;
}

// ascending key of descending value: NaN 0, then +inf ... -inf; -0 as +0
__device__ __forceinline__ uint32_t k13_key(float v) {
  if (v != v) return 0u;
  const uint32_t x = __float_as_uint(v + 0.0f);
  const uint32_t ord = (x & 0x80000000u) ? ~x : (x | 0x80000000u);
  return ~ord;
}

struct K13Shared {
  unsigned int hist[256];
  unsigned int warp_n[K13_SELECT_THREADS / 32];
  unsigned int prefix, remaining, n_less, eq_taken;
};

// The k smallest (key, row) pairs among the n candidates i -> row
// base + i * stride of g (row-major, the row index in the low 32 bits),
// sorted ascending into buf[0, k); buf has room for Kp >= k entries.
__device__ void k13_select_sorted(const float* g, int base, int stride, int n, int k, int Kp,
                                  unsigned long long* buf, K13Shared& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x, nwarps = nthr >> 5;
  // ---- radix select of the k-th smallest key ----
  uint32_t prefix = 0u, pmask = 0u;
  if (tid == 0) s.remaining = (unsigned int)k;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += nthr) s.hist[b] = 0u;
    __syncthreads();
    for (int i = tid; i < n; i += nthr) {
      const uint32_t key = k13_key(g[base + (long long)i * stride]);
      if ((key & pmask) == prefix) atomicAdd(&s.hist[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid == 0) {
      unsigned int rem = s.remaining, cum = 0u;
      int b = 0;
      for (; b < 255; ++b) {
        if (cum + s.hist[b] >= rem) break;
        cum += s.hist[b];
      }
      s.remaining = rem - cum;
      s.prefix = prefix | ((uint32_t)b << shift);
    }
    __syncthreads();
    prefix = s.prefix;
    pmask |= 255u << shift;
  }
  // ---- take every key below the threshold, and the first `need` at it ----
  const uint32_t thr = prefix;
  const unsigned int need = s.remaining, n_less = (unsigned int)k - need;
  if (tid == 0) {
    s.n_less = 0u;
    s.eq_taken = 0u;
  }
  __syncthreads();
  for (int c0 = 0; c0 < n; c0 += nthr) {
    const int i = c0 + tid;
    uint32_t key = 0xFFFFFFFFu;
    int rowi = 0;
    if (i < n) {
      rowi = base + i * stride;
      key = k13_key(g[rowi]);
    }
    const unsigned long long pair = ((unsigned long long)key << 32) | (unsigned int)rowi;
    if (i < n && key < thr) buf[atomicAdd(&s.n_less, 1u)] = pair;
    const bool eq = i < n && key == thr;
    const unsigned int ballot = __ballot_sync(0xFFFFFFFFu, eq);
    if (lane == 0) s.warp_n[warp] = __popc(ballot);
    __syncthreads();
    unsigned int off = s.eq_taken, total = 0u;
    for (int x = 0; x < nwarps; ++x) {
      if (x < warp) off += s.warp_n[x];
      total += s.warp_n[x];
    }
    const unsigned int rank = off + __popc(ballot & ((1u << lane) - 1u));
    if (eq && rank < need) buf[n_less + rank] = pair;
    __syncthreads();
    if (tid == 0) s.eq_taken += total;
    __syncthreads();
  }
  // ---- bitonic sort of buf[0, Kp), the tail padded with the largest pair ----
  for (int i = k + tid; i < Kp; i += nthr) buf[i] = 0xFFFFFFFFFFFFFFFFull;
  __syncthreads();
  for (int size = 2; size <= Kp; size <<= 1) {
    for (int stride2 = size >> 1; stride2 > 0; stride2 >>= 1) {
      for (int t = tid; t < (Kp >> 1); t += nthr) {
        const int lo = 2 * t - (t & (stride2 - 1));
        const int hi = lo + stride2;
        const bool up = (lo & size) == 0;
        const unsigned long long x = buf[lo], y = buf[hi];
        if ((x > y) == up) {
          buf[lo] = y;
          buf[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(K13_SELECT_THREADS) k13_select(const __grid_constant__ K13Args a) {
  extern __shared__ unsigned long long k13_smem[];
  __shared__ K13Shared s;
  const int w = blockIdx.x;
  unsigned long long* buf = a.smem_sort ? k13_smem : a.sort + (long long)w * a.Kp;
  float* g = a.g + (long long)w * a.N;
  int* out = a.idx + (long long)w * a.K;
  int done = 0;
  if (a.quota > 0) {
    const int q = a.quota;
    for (int o = 0; o < a.O; ++o) {
      int Kq = 1;
      while (Kq < q) Kq <<= 1;
      k13_select_sorted(g, o, a.O, a.TJ, q, Kq, buf, s);
      for (int r = threadIdx.x; r < q; r += blockDim.x) {
        const int n = (int)(buf[r] & 0xFFFFFFFFull);
        out[o * q + r] = n;
        g[n] = -INFINITY;
      }
      __syncthreads();
    }
    done = q * a.O;
  }
  int Kf = 1;
  while (Kf < a.K - done) Kf <<= 1;
  k13_select_sorted(g, 0, 1, a.N, a.K - done, Kf, buf, s);
  for (int r = threadIdx.x; r < a.K - done; r += blockDim.x)
    out[done + r] = (int)(buf[r] & 0xFFFFFFFFull);
}

__global__ void __launch_bounds__(K13_GATHER_THREADS) k13_gather(const __grid_constant__ K13Args a) {
  const long long K = a.K, C = a.C, N = a.N;
  const long long e = (long long)blockIdx.x * K13_GATHER_THREADS + threadIdx.x;
  if (e >= (long long)a.W * C * K) return;
  const int w = (int)(e / (C * K));
  const long long rem = e - w * C * K;
  const int c = (int)(rem / K), k = (int)(rem - c * K);
  const int n = a.idx[w * K + k];
  const float* A = a.A + (long long)w * 3 * C * N;
  float* Ao = a.A_out + (long long)w * 3 * C * K;
  for (int x = 0; x < 3; ++x) Ao[(x * C + c) * K + k] = A[(x * C + c) * N + n];
  a.d_out[(w * C + c) * K + k] = a.d[(w * C + c) * N + n];
  a.delta_out[(w * C + c) * K + k] = a.delta[(w * C + c) * N + n];
  if (c == 0) {
    const int tj = n / a.O;
    a.row[w * K + k] = tj;
    a.mask[w * K + k] = a.obs_mask[(long long)w * a.O + (n - tj * a.O)];
  }
}

extern "C" int k13_launch(const K13Args* args, int smem_bytes, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 gb((unsigned int)((args->N + K13_BOUND_THREADS - 1) / K13_BOUND_THREADS),
                (unsigned int)args->W);
  k13_bound<<<gb, K13_BOUND_THREADS, 0, st>>>(*args);
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k13_select, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  k13_select<<<(unsigned int)args->W, K13_SELECT_THREADS, smem_bytes, st>>>(*args);
  const long long total = (long long)args->W * args->C * args->K;
  k13_gather<<<(unsigned int)((total + K13_GATHER_THREADS - 1) / K13_GATHER_THREADS),
               K13_GATHER_THREADS, 0, st>>>(*args);
  return (int)cudaGetLastError();
}
