// K6: the safety oracles of one move, over every logged state.
//
// Replaces armour_tpu/simulator.py:217-258 (make_oracles.check, vmapped
// over worlds by batch_sim.py:178) with its obb_obb_separated (:174-196),
// obstacle_axes_halves (:199-208) and forward_kinematics
// (rnea_numeric.py:55-76).  Per (world, logged step, link):
//   the link box: FK frame R (columns = box axes), centre p + R c_link,
//     half extents link_generators;
//   every obstacle: unit axes = generator columns / their norm (a zero
//     generator, norm <= 1e-12, gets the coordinate axis), half extents =
//     the norms; the 15-axis separating-axis test (3 link axes, 3 obstacle
//     axes, 9 cross products; an axis counts only when its norm > 1e-9);
//   an unseparated real obstacle is an overlap: flag 0 (collision) and one
//     more in the world's overlap count.
// Per (world, logged step, joint j < F): |u| over the torque limit (flag
// 1), |q - q_des| > qe or |qd - qd_des| > qde (flag 2), q outside its
// position limits or |qd| over the speed limit (flag 3).
//
// Bound on the H100 (flagship, W = 64, n = 500, J = 7, O = 40): at most
// 8.96M (state, link, obstacle) triples x 15 axes; it reads 4.5 MB of logs
// (1.3 us at 3.35 TB/s), so it is bound by operations.  The test stops at
// the first separating axis, so the work depends on the data: chip_smoke.py
// (check_oracles, sat_axes_needed) counts what a run's logs need, with FK
// once per logged state and the obstacle axes once per world and obstacle.
//
// Design: a block of 256 threads per (world, chunk of 32 logged steps, split).
//   - Warp 0 runs the FK chain once per logged step, a lane per step, and
//     keeps every link's frame and box centre in shared memory, laid out
//     [link][value][step] so that a warp's lanes read neighbouring words.
//   - Warp 1 computes the unit axes and half extents of the world's real
//     obstacles once each and stages them, compacted in order, in shared
//     memory (32 floats an obstacle).
//   - A face axis's normalised direction and the radius of its own box
//     along it do not depend on the other box: they are formed once per
//     (step, link) and once per obstacle, next to the frames, so that a
//     test that ends at a face axis (most do) costs one projection radius
//     and one distance.
//   - Every warp then takes (link, obstacle) pairs of the chunk, a lane per
//     logged step: neighbouring steps of one link against one obstacle
//     leave the separating-axis test at nearly the same axis, so the lanes
//     of a warp do nearly the same work.  When the worlds x chunks are too
//     few to fill the card, `splits` blocks share a chunk's pairs (each runs
//     the chunk's FK again; that happens only at small W).
//   - The overlap counts are summed within the warp (__reduce_add_sync),
//     then over the block; the joint flags are ORed over the block
//     (__syncthreads_or).  One thread of the block then makes one atomic add
//     to the world's count and writes each raised flag (a store of 1: an OR
//     of ones needs no read).  k6_launch zeroes the one output buffer
//     (counts, then flags) with one cudaMemsetAsync before the kernel; no
//     block zeroes anything.
// Up to K6_MAXJ = 9 links: the grasp path's Kinova with the dumbbell has 9
// bodies, the last two on fixed joints (F = 7): their frames follow the
// chain with the identity axis rotation and their boxes are tested like the
// others; the joint flags cover the F logged joints.  The staged frames take
// 4 (9 x 27 x 32 + 32 O) bytes of dynamic shared memory, 36,224 at O = 40.
// Each axis test repeats the plain version's float32 arithmetic up to the
// order of 3-term sums, in the same order as the first design (one thread per
// (world, step, link)), so the flags and counts are the same bits as before.
// Built with -fmad=false and no fast math.
#include <cuda_runtime.h>

#define K6_MAXJ 9
#define K6_STEPS 32            // logged steps of a chunk: one per lane
#define K6_THREADS 256
#define K6_WARPS (K6_THREADS / 32)
#define K6_MAXSPLIT 16         // blocks that may share one chunk's (link, obstacle) pairs
#define K6_FRAME 27            // floats of a link frame: R (9, row-major), box centre (3),
                               // its face axes' terms (3 x K6_AXIS)
#define K6_OBS 32              // floats of a staged obstacle: axes (9), halves (3), centre (3),
                               // a pad, its face axes' terms (3 x K6_AXIS), a pad
#define K6_AXIS 5              // a face axis's terms: unit axis (3), box radius along it, norm

struct K6Robot {
  int J, F;
  int axes[K6_MAXJ];
  float trans[(K6_MAXJ + 1) * 3];
  float rot[K6_MAXJ * 9];
  float link_c[K6_MAXJ * 3];
  float link_h[K6_MAXJ * 3];
  float torque_lim[K6_MAXJ];
  float pos_lb[K6_MAXJ];
  float pos_ub[K6_MAXJ];
  float speed_lim[K6_MAXJ];
  float qe, qde;
};

struct K6Args {
  K6Robot rb;
  const float* q;              // [W, N, F]
  const float* qd;
  const float* u;
  const float* q_des;
  const float* qd_des;
  const float* centers;        // [W, O, 3]
  const float* gens;           // [W, O, 3, 3] (columns = generators)
  const unsigned char* mask;   // [W, O]
  void* out;                   // overlaps [W] (uint64), then flags [W, 4] (bytes)
  int W, N, O;
  int chunks, splits;          // blocks per world: chunks x splits
};

// dynamic shared memory of a block: the chunk's link frames, the staged obstacles
static __host__ __device__ __forceinline__ size_t k6_smem(int O) {
  return sizeof(float) * ((size_t)K6_MAXJ * K6_FRAME * K6_STEPS + (size_t)K6_OBS * O);
}

__device__ __forceinline__ float k6_dot(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// FK of one logged state: the frame of every link i < J into fr[(i K6_FRAME +
// v) K6_STEPS] (the caller's lane offset applied), as the first design
// formed it link by link.
__device__ __forceinline__ void k6_fk(const K6Robot& rb, const float* q, float* fr) {
  float R[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  float p[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < rb.J; ++i) {
    const float* t = rb.trans + 3 * i;
    float Rt[3];
    for (int a = 0; a < 3; ++a) Rt[a] = R[3 * a] * t[0] + R[3 * a + 1] * t[1] + R[3 * a + 2] * t[2];
    for (int a = 0; a < 3; ++a) p[a] = p[a] + Rt[a];
    float Ra[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    const int axis = rb.axes[i];
    if (axis != 0 && i < rb.F) {
      const float th = (axis > 0 ? 1.0f : -1.0f) * q[i];
      const float c = cosf(th), s = sinf(th);
      const int ax = (axis > 0 ? axis : -axis) - 1;
      if (ax == 0) {
        Ra[4] = c; Ra[5] = -s; Ra[7] = s; Ra[8] = c;
      } else if (ax == 1) {
        Ra[0] = c; Ra[2] = s; Ra[6] = -s; Ra[8] = c;
      } else {
        Ra[0] = c; Ra[1] = -s; Ra[3] = s; Ra[4] = c;
      }
    }
    const float* P = rb.rot + 9 * i;
    float Ri[9], Rn[9];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        Ri[3 * a + b] = P[3 * a] * Ra[b] + P[3 * a + 1] * Ra[3 + b] + P[3 * a + 2] * Ra[6 + b];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b)
        Rn[3 * a + b] = R[3 * a] * Ri[b] + R[3 * a + 1] * Ri[3 + b] + R[3 * a + 2] * Ri[6 + b];
    for (int k = 0; k < 9; ++k) R[k] = Rn[k];
    const float* lc = rb.link_c + 3 * i;
    float* f = fr + i * K6_FRAME * K6_STEPS;
    for (int k = 0; k < 9; ++k) f[k * K6_STEPS] = R[k];
    for (int a = 0; a < 3; ++a)
      f[(9 + a) * K6_STEPS] =
          p[a] + (R[3 * a] * lc[0] + R[3 * a + 1] * lc[1] + R[3 * a + 2] * lc[2]);
  }
}

// The terms of face axis L of a box with unit axes X[0..2] and half extents
// h along it: the norm of L, L / norm and the box's radius along it, as the
// first design formed them in each test.  out[v * stride], v < K6_AXIS.
__device__ __forceinline__ void k6_face_terms(const float L[3], const float X[3][3],
                                              const float h[3], float* out, int stride) {
  const float nrm = sqrtf(L[0] * L[0] + L[1] * L[1] + L[2] * L[2]);
  const float Ln[3] = {L[0] / nrm, L[1] / nrm, L[2] / nrm};
  for (int a = 0; a < 3; ++a) out[a * stride] = Ln[a];
  out[3 * stride] = h[0] * fabsf(k6_dot(X[0], Ln)) + h[1] * fabsf(k6_dot(X[1], Ln))
                    + h[2] * fabsf(k6_dot(X[2], Ln));
  out[4 * stride] = nrm;
}

// Unit axes, half extents, centre and face-axis terms of one obstacle into
// ob[0..K6_OBS).
__device__ __forceinline__ void k6_stage_obstacle(const float* G, const float* cb, float* ob) {
  float Bx[3][3], hb[3];
  for (int k = 0; k < 3; ++k) {
    const float g[3] = {G[k], G[3 + k], G[6 + k]};
    const float h = sqrtf(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]);
    const bool ok = h > 1e-12f;
    const float den = fmaxf(h, 1e-12f);
    for (int a = 0; a < 3; ++a) Bx[k][a] = ok ? g[a] / den : (a == k ? 1.0f : 0.0f);
    hb[k] = h;
  }
  for (int k = 0; k < 3; ++k) {
    for (int a = 0; a < 3; ++a) ob[3 * k + a] = Bx[k][a];
    ob[9 + k] = hb[k];
    k6_face_terms(Bx[k], Bx, hb, ob + 16 + K6_AXIS * k, 1);
  }
  for (int a = 0; a < 3; ++a) ob[12 + a] = cb[a];
  ob[15] = 0.0f;
  ob[31] = 0.0f;
}

// The separating-axis test of a link box (frame f: this lane's word of the
// staged frame, stride K6_STEPS; half extents ha) against a staged obstacle
// ob: true when some valid axis separates them.  The axes in the first
// design's order, each with its arithmetic; the face axes' terms come
// staged.
__device__ __forceinline__ bool k6_separated(const float* f, const float* ha, const float* ob) {
  float A[3][3], ca[3], Bx[3][3], hb[3];
  for (int i = 0; i < 3; ++i)                // A[i] = link box axis i (column i of R)
    for (int a = 0; a < 3; ++a) A[i][a] = f[(3 * a + i) * K6_STEPS];
  for (int a = 0; a < 3; ++a) ca[a] = f[(9 + a) * K6_STEPS];
  for (int k = 0; k < 3; ++k) {
    for (int a = 0; a < 3; ++a) Bx[k][a] = ob[3 * k + a];
    hb[k] = ob[9 + k];
  }
  const float d[3] = {ob[12] - ca[0], ob[13] - ca[1], ob[14] - ca[2]};
  for (int ax = 0; ax < 3; ++ax) {           // the link's face axes
    const float* t = f + (12 + K6_AXIS * ax) * K6_STEPS;
    if (!(t[4 * K6_STEPS] > 1e-9f)) continue;
    const float Ln[3] = {t[0], t[K6_STEPS], t[2 * K6_STEPS]};
    const float rb2 = hb[0] * fabsf(k6_dot(Bx[0], Ln)) + hb[1] * fabsf(k6_dot(Bx[1], Ln))
                      + hb[2] * fabsf(k6_dot(Bx[2], Ln));
    if (fabsf(k6_dot(d, Ln)) > t[3 * K6_STEPS] + rb2) return true;
  }
  for (int ax = 0; ax < 3; ++ax) {           // the obstacle's face axes
    const float* t = ob + 16 + K6_AXIS * ax;
    if (!(t[4] > 1e-9f)) continue;
    const float Ln[3] = {t[0], t[1], t[2]};
    const float ra = ha[0] * fabsf(k6_dot(A[0], Ln)) + ha[1] * fabsf(k6_dot(A[1], Ln))
                     + ha[2] * fabsf(k6_dot(A[2], Ln));
    if (fabsf(k6_dot(d, Ln)) > ra + t[3]) return true;
  }
  for (int ax = 6; ax < 15; ++ax) {          // the cross products
    const float* x = A[(ax - 6) / 3];
    const float* y = Bx[(ax - 6) % 3];
    const float L[3] = {x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2],
                        x[0] * y[1] - x[1] * y[0]};
    const float nrm = sqrtf(L[0] * L[0] + L[1] * L[1] + L[2] * L[2]);
    if (!(nrm > 1e-9f)) continue;
    const float Ln[3] = {L[0] / nrm, L[1] / nrm, L[2] / nrm};
    const float ra = ha[0] * fabsf(k6_dot(A[0], Ln)) + ha[1] * fabsf(k6_dot(A[1], Ln))
                     + ha[2] * fabsf(k6_dot(A[2], Ln));
    const float rb2 = hb[0] * fabsf(k6_dot(Bx[0], Ln)) + hb[1] * fabsf(k6_dot(Bx[1], Ln))
                      + hb[2] * fabsf(k6_dot(Bx[2], Ln));
    if (fabsf(k6_dot(d, Ln)) > ra + rb2) return true;
  }
  return false;
}

__global__ void __launch_bounds__(K6_THREADS) k6_kernel(const K6Args args) {
  extern __shared__ float4 k6_smem_f4[];
  float* fr = (float*)k6_smem_f4;                      // [K6_MAXJ][K6_FRAME][K6_STEPS]
  float* obs = fr + K6_MAXJ * K6_FRAME * K6_STEPS;     // [real obstacles][K6_OBS]
  __shared__ unsigned int s_hits[K6_WARPS];
  __shared__ int s_nobs;
  const K6Robot& rb = args.rb;
  const int J = rb.J, F = rb.F, N = args.N, O = args.O, splits = args.splits;
  const int per_world = args.chunks * splits;
  const int w = blockIdx.x / per_world;
  const int r = blockIdx.x - w * per_world;
  const int chunk = r / splits, split = r - chunk * splits;
  const int s0 = chunk * K6_STEPS, ns = min(K6_STEPS, N - s0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 0) {
    if (lane < ns) k6_fk(rb, args.q + ((long long)w * N + s0 + lane) * F, fr + lane);
  } else if (warp == 1) {
    // the real obstacles, compacted in order
    int base = 0;
    for (int o0 = 0; o0 < O; o0 += 32) {
      const int o = o0 + lane;
      const bool real = o < O && args.mask[(long long)w * O + o] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, real);
      if (real) {
        const long long wo = (long long)w * O + o;
        k6_stage_obstacle(args.gens + wo * 9, args.centers + wo * 3,
                          obs + K6_OBS * (base + __popc(m & ((1u << lane) - 1u))));
      }
      base += __popc(m);
    }
    if (lane == 0) s_nobs = base;
  }
  // the joint flags of the chunk's steps (split 0 only)
  bool torque = false, bound = false, joint = false;
  if (split == 0) {
    for (int it = threadIdx.x; it < ns * F; it += K6_THREADS) {
      const int j = it % F;
      const long long e = ((long long)w * N + s0) * F + it;
      const float qv = args.q[e], qdv = args.qd[e];
      torque |= fabsf(args.u[e]) > rb.torque_lim[j];
      bound |= fabsf(qv - args.q_des[e]) > rb.qe || fabsf(qdv - args.qd_des[e]) > rb.qde;
      joint |= qv < rb.pos_lb[j] || qv > rb.pos_ub[j] || fabsf(qdv) > rb.speed_lim[j];
    }
  }
  __syncthreads();
  // the link face axes' terms, a thread per (link, step)
  for (int it = threadIdx.x; it < J * K6_STEPS; it += K6_THREADS) {
    const int j = it / K6_STEPS, st = it - j * K6_STEPS;
    if (st < ns) {
      float* f = fr + j * K6_FRAME * K6_STEPS + st;
      float A[3][3];
      for (int i = 0; i < 3; ++i)
        for (int a = 0; a < 3; ++a) A[i][a] = f[(3 * a + i) * K6_STEPS];
      for (int ax = 0; ax < 3; ++ax)
        k6_face_terms(A[ax], A, rb.link_h + 3 * j, f + (12 + K6_AXIS * ax) * K6_STEPS, K6_STEPS);
    }
  }
  __syncthreads();

  // (link, obstacle) pairs of the chunk, a lane per logged step: pair p is
  // (p / nobs, p % nobs), warp w of split r takes p = r + splits (w + K6_WARPS i)
  const int nobs = s_nobs, npairs = J * nobs, stride = splits * K6_WARPS;
  unsigned int hits = 0;
  int p = split + splits * warp;
  int j = nobs ? p / nobs : 0, k = p - j * nobs;
  for (; p < npairs; p += stride) {
    if (lane < ns && !k6_separated(fr + j * K6_FRAME * K6_STEPS + lane, rb.link_h + 3 * j,
                                   obs + K6_OBS * k))
      ++hits;
    for (k += stride; k >= nobs && j < J; k -= nobs) ++j;
  }
  hits = __reduce_add_sync(0xffffffffu, hits);
  if (lane == 0) s_hits[warp] = hits;
  torque = __syncthreads_or(torque);
  bound = __syncthreads_or(bound);
  joint = __syncthreads_or(joint);
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < K6_WARPS; ++i) total += s_hits[i];
    unsigned long long* overlaps = (unsigned long long*)args.out;
    unsigned char* flags = (unsigned char*)(overlaps + args.W) + 4 * w;
    if (total) {
      atomicAdd(overlaps + w, total);
      flags[0] = 1;
    }
    if (torque) flags[1] = 1;
    if (bound) flags[2] = 1;
    if (joint) flags[3] = 1;
  }
}

// Zeroes the output buffer, then launches W x chunks x splits blocks.
extern "C" int k6_launch(const K6Args* args, void* stream) {
  const K6Robot& rb = args->rb;
  if (rb.J > K6_MAXJ || rb.F > rb.J || args->splits < 1 || args->splits > K6_MAXSPLIT
      || (long long)args->chunks * K6_STEPS < args->N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(args->out, 0, (size_t)args->W * (8 + 4), s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = k6_smem(args->O);
  err = cudaFuncSetAttribute(k6_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long grid = (long long)args->W * args->chunks * args->splits;
  k6_kernel<<<(unsigned int)grid, K6_THREADS, smem, s>>>(*args);
  return (int)cudaGetLastError();
}
