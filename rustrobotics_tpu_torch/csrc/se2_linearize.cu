// SE2 linearization (pose-pose and pose-landmark edges) for Hopper (sm_90a),
// IEEE f32.
//
// It replaces no TPU kernel. The JAX package leaves this step
// (mapping/assemble.py::system_values over linearize.py's component-form
// edge terms) to XLA, which fuses its elementwise chain. The port's plain
// PyTorch version runs it as ~224 aten calls and 98 kernel launches a call:
// ~3.1 ms of host time for ~0.17 ms of device time on corridor-1728, which
// left the card idle while the host linearized. This file is the same step
// in two launches.
//
// What it computes, for each graph g of a batch (a fleet's leading axis) and
// each SE2 pose-pose edge (residual chart(z^-1 x1^-1 x2)) and SE2
// pose-landmark edge (residual R^T (l - t) - z): the closed-form Jacobians A
// and B, the blocks Hii = A^T W A, Hij = A^T W B, Hji = Hij^T, Hjj = B^T W B,
// the right-hand side parts bi = A^T W e, bj = B^T W e, and the edge's
// chi^2 = e^T W e (W the edge's information matrix). The blocks go straight
// into the triplet values vals[g] in assemble.build_layout's order:
// entry-major, entry k of edge e at k E + e, the pose-pose blocks, then the
// pose-landmark blocks, then the gauge prior's entries, then lambda on every
// diagonal. It also writes -b and the total chi^2.
//
// Numerics: the plain path's, operation by operation. Each product and sum is
// one IEEE f32 operation in the plain path's order (__fmul_rn / __fadd_rn,
// which the compiler never contracts into an FMA); a sum of 2 or 3 terms runs
// from 0 in index order, as PyTorch's sum reduces so short an axis; sinf and
// cosf; the angle wrap is torch.remainder's (fmodf, then one add of 2 pi to a
// negative result). No fast-math. So vals equal the plain CUDA path's bit for
// bit. b sums each dof's parts from 0 in a fixed order (below) where the
// plain path's index_add_ adds them with atomics in an order that changes
// from run to run; the total chi^2 is summed in a fixed tree, not in
// torch.sum's order.
//
// What bounds it: latency. corridor-1728 (4830 edges, n = 5184) reads and
// writes ~1.3 MB (~0.4 us at 3.35 TB/s) and does ~2.9 MFLOP (~0.04 us at
// 67 TFLOP/s): one wave of 19 CTAs, so a launch costs its start-up and one
// chain of dependent loads (edge index, then pose, then the stores).
//
// The design: two launches, no memset, no atomics.
// - se2_edge_terms: one thread per (edge, graph). A thread reads its edge's
//   indices, poses, measurement and information matrix once (__ldg), keeps
//   everything in registers, and stores entry k of its edge at k E + e, so a
//   warp's stores are coalesced. Its bi, bj go to a parts buffer in the same
//   entry-major order (the order of the plain path's index_add_ sources), its
//   chi^2 into one partial sum a CTA (a fixed shuffle tree).
// - se2_rhs_gather: one thread per (dof, graph). The incidence plan (built on
//   the host once a graph structure, by mapping/assemble.py::build_layout)
//   lists each dof's parts in the order the CPU's index_add_ adds them; the
//   thread sums them from 0 and stores -b, so b is the same every run and
//   bit-equal to the CPU's index_add_ over the same parts. It also writes the
//   dof's lambda entry and the gauge prior's entries, and the first warp of
//   each graph sums the chi^2 partials in a fixed order.
//
// The entry point has a plain C interface for ctypes, takes the device of its
// tensors and returns the cudaError_t of its calls (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // ops/linearize_kernels.py's EDGE_THREADS
constexpr float PI = 3.14159265358979323846f;
constexpr float TWO_PI = 6.28318530717958647692f;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

__device__ __forceinline__ int64_t load_index(const int64_t* p) {
  return static_cast<int64_t>(__ldg(reinterpret_cast<const long long*>(p)));
}

// utils/angles.py::wrap_angle in f32: remainder(t + pi, 2 pi) - pi.
__device__ __forceinline__ float wrap_angle(float t) {
  float m = fmodf(add(t, PI), TWO_PI);
  if (m != 0.f && m < 0.f) m = add(m, TWO_PI);
  return sub(m, PI);
}

// linearize._mat_tmul: out[m][n] = sum_r a[r][m] b[r][n], from 0, r in order.
template <int R, int M, int N>
__device__ __forceinline__ void tmul(const float (&a)[R][M],
                                     const float (&b)[R][N],
                                     float (&out)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) s = add(s, mul(a[r][m], b[r][n]));
      out[m][n] = s;
    }
}

// linearize._mat_tvec: out[m] = sum_r a[r][m] v[r].
template <int R, int M>
__device__ __forceinline__ void tvec(const float (&a)[R][M],
                                     const float (&v)[R], float (&out)[M]) {
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) s = add(s, mul(a[r][m], v[r]));
    out[m] = s;
  }
}

template <int R, int C>
__device__ __forceinline__ void load_mat(const float* p, float (&m)[R][C]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) m[r][c] = __ldg(p + r * C + c);
}

// Entry-major stores of one edge's (M, N) block, o at the edge's first
// entry: entry (m, n) at (m N + n) edges.
template <int M, int N>
__device__ __forceinline__ void store_block(float* o, int64_t edges,
                                            const float (&h)[M][N]) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) o[(m * N + n) * edges] = h[m][n];
}

// ... and of its transpose, an (N, M) block.
template <int M, int N>
__device__ __forceinline__ void store_block_t(float* o, int64_t edges,
                                              const float (&h)[M][N]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int m = 0; m < M; ++m) o[(n * M + m) * edges] = h[m][n];
}

template <int M>
__device__ __forceinline__ void store_vec(float* o, int64_t edges,
                                          const float (&v)[M]) {
#pragma unroll
  for (int m = 0; m < M; ++m) o[m * edges] = v[m];
}

struct Inputs {
  const float* poses;  // (N2, 3) a graph
  const float* lms;    // (L2, 2)
  const int64_t *pp_from, *pp_to;
  const float *pp_z, *pp_om;  // (E_pp, 3), (E_pp, 3, 3)
  const int64_t *pl_pose, *pl_lm;
  const float *pl_z, *pl_om;  // (E_pl, 2), (E_pl, 2, 2)
  // floats between one graph's inputs and the next's (0: shared)
  int64_t pose_stride, lm_stride, pp_z_stride, pp_om_stride, pl_z_stride,
      pl_om_stride;
  int64_t n_pp, n_pl;
};

// linearize.edge_terms_pp_soa for edge e of graph g: the blocks at vals,
// the parts at parts; returns the edge's chi^2.
__device__ __forceinline__ float pose_pose(const Inputs& in, int64_t g,
                                           int64_t e, float* vals,
                                           float* parts) {
  const int64_t E = in.n_pp;
  const float* poses = in.poses + g * in.pose_stride;
  const float* x1p = poses + 3 * load_index(in.pp_from + e);
  const float* x2p = poses + 3 * load_index(in.pp_to + e);
  const float* zp = in.pp_z + g * in.pp_z_stride + 3 * e;
  float om[3][3];
  load_mat<3, 3>(in.pp_om + g * in.pp_om_stride + 9 * e, om);
  const float x1x = __ldg(x1p), x1y = __ldg(x1p + 1), th1 = __ldg(x1p + 2);
  const float x2x = __ldg(x2p), x2y = __ldg(x2p + 1), th2 = __ldg(x2p + 2);
  const float zx = __ldg(zp), zy = __ldg(zp + 1), thz = __ldg(zp + 2);

  const float c1 = cosf(th1), s1 = sinf(th1);
  const float cz = cosf(thz), sz = sinf(thz);
  const float dx = sub(x2x, x1x), dy = sub(x2y, x1y);
  // relative translation in x1's frame
  const float rel_x = add(mul(c1, dx), mul(s1, dy));
  const float rel_y = add(mul(-s1, dx), mul(c1, dy));
  const float ux = sub(rel_x, zx), uy = sub(rel_y, zy);
  const float err[3] = {add(mul(cz, ux), mul(sz, uy)),
                        add(mul(-sz, ux), mul(cz, uy)),
                        wrap_angle(sub(sub(th2, th1), thz))};
  // A = de/dx1, B = de/dx2; cp, sp = cos, sin(th1 + thz)
  const float thp = add(th1, thz);
  const float cp = cosf(thp), sp = sinf(thp);
  const float a12x = sub(mul(cz, rel_y), mul(sz, rel_x));
  const float a12y = sub(mul(-sz, rel_y), mul(cz, rel_x));
  const float a[3][3] = {{-cp, -sp, a12x}, {sp, -cp, a12y}, {0.f, 0.f, -1.f}};
  const float b[3][3] = {{cp, sp, 0.f}, {-sp, cp, 0.f}, {0.f, 0.f, 1.f}};

  float om_a[3][3], om_b[3][3], h[3][3];
  tmul(om, a, om_a);  // W^T A = W A (W symmetric)
  tmul(om, b, om_b);
  tmul(a, om_a, h);  // Hii
  store_block(vals + e, E, h);
  tmul(a, om_b, h);  // Hij, and Hji = Hij^T
  store_block(vals + 9 * E + e, E, h);
  store_block_t(vals + 18 * E + e, E, h);
  tmul(b, om_b, h);  // Hjj
  store_block(vals + 27 * E + e, E, h);

  float om_e[3], bi[3], bj[3];
  tvec(om, err, om_e);
  tvec(a, om_e, bi);
  tvec(b, om_e, bj);
  store_vec(parts + e, E, bi);
  store_vec(parts + 3 * E + e, E, bj);
  float c2 = 0.f;
#pragma unroll
  for (int r = 0; r < 3; ++r) c2 = add(c2, mul(err[r], om_e[r]));
  return c2;
}

// linearize.edge_terms_pl_soa for edge e of graph g.
__device__ __forceinline__ float pose_landmark(const Inputs& in, int64_t g,
                                               int64_t e, float* vals,
                                               float* parts) {
  const int64_t E = in.n_pl;
  const float* xp = in.poses + g * in.pose_stride +
                    3 * load_index(in.pl_pose + e);
  const float* lp = in.lms + g * in.lm_stride + 2 * load_index(in.pl_lm + e);
  const float* zp = in.pl_z + g * in.pl_z_stride + 2 * e;
  float om[2][2];
  load_mat<2, 2>(in.pl_om + g * in.pl_om_stride + 4 * e, om);
  const float xx = __ldg(xp), xy = __ldg(xp + 1), th = __ldg(xp + 2);
  const float lx = __ldg(lp), ly = __ldg(lp + 1);
  const float zx = __ldg(zp), zy = __ldg(zp + 1);

  const float c = cosf(th), s = sinf(th);
  const float dx = sub(lx, xx), dy = sub(ly, xy);
  // e = R^T (l - t) - z; A (2x3) = [-R^T | dR^T (l - t)], B (2x2) = R^T
  const float a02 = add(mul(-s, dx), mul(c, dy));
  const float a12 = sub(mul(-c, dx), mul(s, dy));
  const float err[2] = {sub(add(mul(c, dx), mul(s, dy)), zx), sub(a02, zy)};
  const float a[2][3] = {{-c, -s, a02}, {s, -c, a12}};
  const float b[2][2] = {{c, s}, {-s, c}};

  float om_a[2][3], om_b[2][2], hii[3][3], hij[3][2], hjj[2][2];
  tmul(om, a, om_a);
  tmul(om, b, om_b);
  tmul(a, om_a, hii);
  tmul(a, om_b, hij);
  tmul(b, om_b, hjj);
  store_block(vals + e, E, hii);
  store_block(vals + 9 * E + e, E, hij);
  store_block_t(vals + 15 * E + e, E, hij);
  store_block(vals + 21 * E + e, E, hjj);

  float om_e[2], bi[3], bj[2];
  tvec(om, err, om_e);
  tvec(a, om_e, bi);
  tvec(b, om_e, bj);
  store_vec(parts + e, E, bi);
  store_vec(parts + 3 * E + e, E, bj);
  return add(add(0.f, mul(err[0], om_e[0])), mul(err[1], om_e[1]));
}

// grid (edge blocks, graphs). Thread i < E_pp takes pose-pose edge i, the
// next E_pl threads the pose-landmark edges. vals[g] from pp_base on and
// parts[g] (6 E_pp + 5 E_pl) are written in full; partial[g][block] gets the
// CTA's chi^2.
__global__ void __launch_bounds__(THREADS)
se2_edge_terms(Inputs in, int64_t pl_base, float* __restrict__ vals,
               int64_t nnz, float* __restrict__ parts, int64_t n_parts,
               float* __restrict__ partial) {
  const int64_t g = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  float* v = vals + g * nnz;
  float* p = parts + g * n_parts;
  float c2 = 0.f;
  if (i < in.n_pp)
    c2 = pose_pose(in, g, i, v, p);
  else if (i < in.n_pp + in.n_pl)
    c2 = pose_landmark(in, g, i - in.n_pp, v + pl_base, p + 6 * in.n_pp);

  // the CTA's chi^2: a fixed tree within each warp, then the warps in order
  __shared__ float warp_sum[THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    c2 = add(c2, __shfl_down_sync(0xffffffffu, c2, off));
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c2;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) s = add(s, warp_sum[w]);
    partial[g * gridDim.x + blockIdx.x] = s;
  }
}

// grid (dof blocks, graphs): b[g][d] = -(sum of dof d's parts, from 0, in
// plan order), vals[g][lam_base + d] = lambda_g, the prior's entries, and
// chi2[g] = the sum of graph g's n_partial partials.
__global__ void __launch_bounds__(THREADS)
se2_rhs_gather(const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ src,
               const float* __restrict__ parts, int64_t n_parts,
               const float* __restrict__ partial, int n_partial, int64_t n,
               int64_t prior, int64_t prior_base, float prior_weight,
               const float* __restrict__ lam, int64_t lam_stride,
               float lam_value, int64_t lam_base, float* __restrict__ vals,
               int64_t nnz, float* __restrict__ b,
               float* __restrict__ chi2) {
  const int64_t g = blockIdx.y;
  const int64_t d = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  if (d < n) {
    const float* p = parts + g * n_parts;
    float s = 0.f;
    for (int32_t k = __ldg(ptr + d), end = __ldg(ptr + d + 1); k < end; ++k)
      s = add(s, p[__ldg(src + k)]);
    b[g * n + d] = -s;
    float* v = vals + g * nnz;
    v[lam_base + d] = lam ? __ldg(lam + g * lam_stride) : lam_value;
    if (d < prior) v[prior_base + d] = prior_weight;
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    float s = 0.f;
    for (int k = threadIdx.x; k < n_partial; k += 32)
      s = add(s, partial[g * n_partial + k]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = add(s, __shfl_down_sync(0xffffffffu, s, off));
    if (threadIdx.x == 0) chi2[g] = s;
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One linearization of `graphs` same-structure SE2 graphs. Inputs: poses
// (graphs, N2, 3), lms (graphs, L2, 2), the edge measurements (E, 3) / (E, 2)
// and information matrices (E, 3, 3) / (E, 2, 2), each with the stride
// between graphs given (0: one copy for all); the edge indices int64. The
// plan: ptr (n + 1,) and src (6 E_pp + 5 E_pl,) int32. lam: (graphs,) at
// lam_stride, or null for lam_value everywhere. Outputs, f32: vals (graphs,
// nnz) with the pose-landmark blocks at pl_base, the prior at prior_base
// and lambda at lam_base = nnz - n; b (graphs, n); chi2 (graphs,); scratch
// (graphs (6 E_pp + 5 E_pl + edge blocks)). Two kernel launches.
int se2_linearize_f32(int device, int graphs, const float* poses,
                      int64_t pose_stride, const float* lms,
                      int64_t lm_stride, const int64_t* pp_from,
                      const int64_t* pp_to, const float* pp_z,
                      int64_t pp_z_stride, const float* pp_om,
                      int64_t pp_om_stride, int64_t n_pp,
                      const int64_t* pl_pose, const int64_t* pl_lm,
                      const float* pl_z, int64_t pl_z_stride,
                      const float* pl_om, int64_t pl_om_stride, int64_t n_pl,
                      const int32_t* ptr, const int32_t* src, int64_t n,
                      int64_t pl_base, int64_t prior_base, int64_t prior,
                      float prior_weight, const float* lam,
                      int64_t lam_stride, float lam_value, float* vals,
                      int64_t nnz, float* b, float* chi2, float* scratch,
                      int64_t scratch_floats, void* stream) {
  const int64_t edges = n_pp + n_pl, n_parts = 6 * n_pp + 5 * n_pl;
  const int64_t edge_blocks = edges > 0 ? (edges + THREADS - 1) / THREADS : 1;
  const int64_t dof_blocks = n > 0 ? (n + THREADS - 1) / THREADS : 1;
  if (graphs < 1 || graphs > 65535 || n_pp < 0 || n_pl < 0 || n < 0 ||
      prior < 0 || prior > n || pl_base != 36 * n_pp ||
      prior_base != pl_base + 25 * n_pl || nnz != prior_base + prior + n ||
      edge_blocks > INT32_MAX || n_parts > INT32_MAX ||
      scratch_floats != graphs * (n_parts + edge_blocks))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Inputs in{poses,       lms,          pp_from,     pp_to,
                  pp_z,        pp_om,        pl_pose,     pl_lm,
                  pl_z,        pl_om,        pose_stride, lm_stride,
                  pp_z_stride, pp_om_stride, pl_z_stride, pl_om_stride,
                  n_pp,        n_pl};
  float* parts = scratch;
  float* partial = scratch + graphs * n_parts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  se2_edge_terms<<<dim3((unsigned)edge_blocks, (unsigned)graphs), THREADS, 0,
                   s>>>(in, pl_base, vals, nnz, parts, n_parts, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  se2_rhs_gather<<<dim3((unsigned)dof_blocks, (unsigned)graphs), THREADS, 0,
                   s>>>(ptr, src, parts, n_parts, partial, (int)edge_blocks,
                        n, prior, prior_base, prior_weight, lam, lam_stride,
                        lam_value, nnz - n, vals, nnz, b, chi2);
  return cudaGetLastError();
}

}  // extern "C"
