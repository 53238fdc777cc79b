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
// The robust form: se2_edge_terms_gnc is se2_edge_terms with graduated
// non-convexity over Geman-McClure (assemble.robust_weight("gnc-gm")). Each
// weighted edge (every closure; every edge under robust_edges="all") scales
// its blocks and parts by w = (s / (c^2 + s))^2, s = mu delta^2, at its own
// chi^2 c^2 and its graph's mu, which it reads from the device; odometry
// keeps w = 1. The same IEEE operations in the order of
// system_values_plain's, so its vals equal the plain CUDA path's too. chi^2
// stays unweighted, as system_values returns it.
//
// LM's accept test: se2_lm_cost gives, in one launch, each graph's
// sum of e^T W e at the trial poses and, for a robust run, the sums of the
// GNC costs rho = s c^2 / (s + c^2) (odometry quadratic) at the trial and at
// the current poses, which pgo's loops compare. One CTA a graph sums in a
// fixed order, the same for both graphs. It reads each edge's indices,
// measurement and information matrix and both graphs' poses once (~0.36 MB
// a graph of intel-1728, ~0.1 us at 3.35 TB/s) and is bound by latency, as
// the edge kernel.
//
// The entry points have a plain C interface for ctypes, take the device of
// their tensors and return the cudaError_t of their calls (0 on success).

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

// The GNC Geman-McClure kernel's parameters: mu a graph (mu[g mu_stride])
// and the scale delta; where mu is null, mu_value is the whole scale s,
// formed on the host as the tensor code forms it from numbers, and delta
// is 1. With closures_only,
// pose-pose edges between consecutive poses (|to - from| = 1, odometry)
// keep weight 1 and a quadratic cost (robust_edges="closures").
struct Gnc {
  const float* mu;
  int64_t mu_stride;
  float mu_value;
  float delta;
  int closures_only;
};

__device__ __forceinline__ float gnc_mu(const Gnc& k, int64_t g) {
  return k.mu ? __ldg(k.mu + g * k.mu_stride) : k.mu_value;
}

// assemble.robust_weight("gnc-gm"): (s / (c2 + s))^2, s = (mu delta) delta;
// torch's pow(q, 2) is q q. A mu given as a number (k.mu null) comes with s
// already formed (delta 1), and torch divides that number by the tensor
// c2 + s as its reciprocal times the number.
__device__ __forceinline__ float gnc_weight(float c2, float mu, const Gnc& k) {
  const float s = mul(mul(mu, k.delta), k.delta);
  const float q = k.mu ? __fdiv_rn(s, add(c2, s))
                       : mul(__frcp_rn(add(c2, s)), s);
  return mul(q, q);
}

// assemble.robust_rho("gnc-gm"): (s c2) / (s + c2), s = mu delta^2.
__device__ __forceinline__ float gnc_rho(float c2, float s) {
  return __fdiv_rn(mul(s, c2), add(s, c2));
}

__device__ __forceinline__ bool odometry(int64_t from, int64_t to) {
  return to - from == 1 || from - to == 1;
}

// The pose-pose residual of edge e at poses (one graph's): linearize.
// edge_terms_pp_soa's e, and what its Jacobians reuse.
struct PpError {
  int64_t from, to;
  float err[3];
  float rel_x, rel_y, th1, thz, cz, sz;
};

__device__ __forceinline__ PpError pp_error(const Inputs& in,
                                            const float* poses, int64_t g,
                                            int64_t e) {
  PpError r;
  r.from = load_index(in.pp_from + e);
  r.to = load_index(in.pp_to + e);
  const float* x1p = poses + 3 * r.from;
  const float* x2p = poses + 3 * r.to;
  const float* zp = in.pp_z + g * in.pp_z_stride + 3 * e;
  const float x1x = __ldg(x1p), x1y = __ldg(x1p + 1);
  const float x2x = __ldg(x2p), x2y = __ldg(x2p + 1), th2 = __ldg(x2p + 2);
  const float zx = __ldg(zp), zy = __ldg(zp + 1);
  r.th1 = __ldg(x1p + 2);
  r.thz = __ldg(zp + 2);
  const float c1 = cosf(r.th1), s1 = sinf(r.th1);
  r.cz = cosf(r.thz);
  r.sz = sinf(r.thz);
  const float dx = sub(x2x, x1x), dy = sub(x2y, x1y);
  // relative translation in x1's frame
  r.rel_x = add(mul(c1, dx), mul(s1, dy));
  r.rel_y = add(mul(-s1, dx), mul(c1, dy));
  const float ux = sub(r.rel_x, zx), uy = sub(r.rel_y, zy);
  r.err[0] = add(mul(r.cz, ux), mul(r.sz, uy));
  r.err[1] = add(mul(-r.sz, ux), mul(r.cz, uy));
  r.err[2] = wrap_angle(sub(sub(th2, r.th1), r.thz));
  return r;
}

// The pose-landmark residual of edge e (linearize.edge_terms_pl_soa's e).
struct PlError {
  float err[2];
  float c, s, dx, dy, a02;
};

__device__ __forceinline__ PlError pl_error(const Inputs& in,
                                            const float* poses,
                                            const float* lms, int64_t g,
                                            int64_t e) {
  PlError r;
  const float* xp = poses + 3 * load_index(in.pl_pose + e);
  const float* lp = lms + 2 * load_index(in.pl_lm + e);
  const float* zp = in.pl_z + g * in.pl_z_stride + 2 * e;
  const float xx = __ldg(xp), xy = __ldg(xp + 1), th = __ldg(xp + 2);
  const float lx = __ldg(lp), ly = __ldg(lp + 1);
  const float zx = __ldg(zp), zy = __ldg(zp + 1);
  r.c = cosf(th);
  r.s = sinf(th);
  r.dx = sub(lx, xx);
  r.dy = sub(ly, xy);
  // e = R^T (l - t) - z
  r.a02 = add(mul(-r.s, r.dx), mul(r.c, r.dy));
  r.err[0] = sub(add(mul(r.c, r.dx), mul(r.s, r.dy)), zx);
  r.err[1] = sub(r.a02, zy);
  return r;
}

// e^T W e from 0 in index order, W e given.
template <int D>
__device__ __forceinline__ float quad(const float (&err)[D],
                                      const float (&om_e)[D]) {
  float c2 = 0.f;
#pragma unroll
  for (int r = 0; r < D; ++r) c2 = add(c2, mul(err[r], om_e[r]));
  return c2;
}

template <int M, int N>
__device__ __forceinline__ void scale(float (&h)[M][N], float w) {
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int n = 0; n < N; ++n) h[m][n] = mul(h[m][n], w);
}

template <int M>
__device__ __forceinline__ void scale(float (&v)[M], float w) {
#pragma unroll
  for (int m = 0; m < M; ++m) v[m] = mul(v[m], w);
}

// linearize.edge_terms_pp_soa for edge e of graph g: the blocks at vals,
// the parts at parts; returns the edge's chi^2. GNC scales the blocks and
// the parts by the edge's weight at mu, as system_values_plain does.
template <bool GNC>
__device__ __forceinline__ float pose_pose(const Inputs& in, int64_t g,
                                           int64_t e, float* vals,
                                           float* parts, const Gnc& k,
                                           float mu) {
  const int64_t E = in.n_pp;
  float om[3][3];
  load_mat<3, 3>(in.pp_om + g * in.pp_om_stride + 9 * e, om);
  const PpError r = pp_error(in, in.poses + g * in.pose_stride, g, e);
  // A = de/dx1, B = de/dx2; cp, sp = cos, sin(th1 + thz)
  const float thp = add(r.th1, r.thz);
  const float cp = cosf(thp), sp = sinf(thp);
  const float a12x = sub(mul(r.cz, r.rel_y), mul(r.sz, r.rel_x));
  const float a12y = sub(mul(-r.sz, r.rel_y), mul(r.cz, r.rel_x));
  const float a[3][3] = {{-cp, -sp, a12x}, {sp, -cp, a12y}, {0.f, 0.f, -1.f}};
  const float b[3][3] = {{cp, sp, 0.f}, {-sp, cp, 0.f}, {0.f, 0.f, 1.f}};

  float om_e[3], bi[3], bj[3];
  tvec(om, r.err, om_e);
  const float c2 = quad(r.err, om_e);
  float w = 1.f;
  if (GNC && !(k.closures_only && odometry(r.from, r.to)))
    w = gnc_weight(c2, mu, k);

  float om_a[3][3], om_b[3][3], h[3][3];
  tmul(om, a, om_a);  // W^T A = W A (W symmetric)
  tmul(om, b, om_b);
  tmul(a, om_a, h);  // Hii
  if (GNC) scale(h, w);
  store_block(vals + e, E, h);
  tmul(a, om_b, h);  // Hij, and Hji = Hij^T
  if (GNC) scale(h, w);
  store_block(vals + 9 * E + e, E, h);
  store_block_t(vals + 18 * E + e, E, h);
  tmul(b, om_b, h);  // Hjj
  if (GNC) scale(h, w);
  store_block(vals + 27 * E + e, E, h);

  tvec(a, om_e, bi);
  tvec(b, om_e, bj);
  if (GNC) {
    scale(bi, w);
    scale(bj, w);
  }
  store_vec(parts + e, E, bi);
  store_vec(parts + 3 * E + e, E, bj);
  return c2;
}

// linearize.edge_terms_pl_soa for edge e of graph g; GNC weighs every
// pose-landmark edge.
template <bool GNC>
__device__ __forceinline__ float pose_landmark(const Inputs& in, int64_t g,
                                               int64_t e, float* vals,
                                               float* parts, const Gnc& k,
                                               float mu) {
  const int64_t E = in.n_pl;
  float om[2][2];
  load_mat<2, 2>(in.pl_om + g * in.pl_om_stride + 4 * e, om);
  const PlError r = pl_error(in, in.poses + g * in.pose_stride,
                             in.lms + g * in.lm_stride, g, e);
  // A (2x3) = [-R^T | dR^T (l - t)], B (2x2) = R^T
  const float a12 = sub(mul(-r.c, r.dx), mul(r.s, r.dy));
  const float a[2][3] = {{-r.c, -r.s, r.a02}, {r.s, -r.c, a12}};
  const float b[2][2] = {{r.c, r.s}, {-r.s, r.c}};

  float om_e[2], bi[3], bj[2];
  tvec(om, r.err, om_e);
  const float c2 = quad(r.err, om_e);
  const float w = GNC ? gnc_weight(c2, mu, k) : 1.f;

  float om_a[2][3], om_b[2][2], hii[3][3], hij[3][2], hjj[2][2];
  tmul(om, a, om_a);
  tmul(om, b, om_b);
  tmul(a, om_a, hii);
  tmul(a, om_b, hij);
  tmul(b, om_b, hjj);
  if (GNC) {
    scale(hii, w);
    scale(hij, w);
    scale(hjj, w);
  }
  store_block(vals + e, E, hii);
  store_block(vals + 9 * E + e, E, hij);
  store_block_t(vals + 15 * E + e, E, hij);
  store_block(vals + 21 * E + e, E, hjj);

  tvec(a, om_e, bi);
  tvec(b, om_e, bj);
  if (GNC) {
    scale(bi, w);
    scale(bj, w);
  }
  store_vec(parts + e, E, bi);
  store_vec(parts + 3 * E + e, E, bj);
  return c2;
}

// grid (edge blocks, graphs). Thread i < E_pp takes pose-pose edge i, the
// next E_pl threads the pose-landmark edges. vals[g] from pp_base on and
// parts[g] (6 E_pp + 5 E_pl) are written in full; partial[g][block] gets the
// CTA's chi^2 (unweighted, as system_values returns it).
template <bool GNC>
__device__ __forceinline__ void edge_terms(const Inputs& in, int64_t pl_base,
                                           float* vals, int64_t nnz,
                                           float* parts, int64_t n_parts,
                                           float* partial, const Gnc& k) {
  const int64_t g = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  float* v = vals + g * nnz;
  float* p = parts + g * n_parts;
  const float mu = GNC ? gnc_mu(k, g) : 1.f;
  float c2 = 0.f;
  if (i < in.n_pp)
    c2 = pose_pose<GNC>(in, g, i, v, p, k, mu);
  else if (i < in.n_pp + in.n_pl)
    c2 = pose_landmark<GNC>(in, g, i - in.n_pp, v + pl_base,
                            p + 6 * in.n_pp, k, mu);

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

// Least squares: every edge at weight 1.
__global__ void __launch_bounds__(THREADS)
se2_edge_terms(Inputs in, int64_t pl_base, float* __restrict__ vals,
               int64_t nnz, float* __restrict__ parts, int64_t n_parts,
               float* __restrict__ partial) {
  edge_terms<false>(in, pl_base, vals, nnz, parts, n_parts, partial, Gnc{});
}

// GNC Geman-McClure: each weighted edge at its IRLS weight at mu.
__global__ void __launch_bounds__(THREADS)
se2_edge_terms_gnc(Inputs in, int64_t pl_base, float* __restrict__ vals,
                   int64_t nnz, float* __restrict__ parts, int64_t n_parts,
                   float* __restrict__ partial, Gnc k) {
  edge_terms<true>(in, pl_base, vals, nnz, parts, n_parts, partial, k);
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

// ------------------------------------------------------- LM's accept test

constexpr int COST_THREADS = 512;  // ops/linearize_kernels.py's COST_THREADS

// e^T W e of edge i (pose-pose edges first, then pose-landmark) of graph g
// at poses and lms, and its cost: the GNC rho at s = mu delta^2 where
// robust and the edge is weighted, else e^T W e.
__device__ __forceinline__ void edge_cost(const Inputs& in,
                                          const float* poses,
                                          const float* lms, int64_t g,
                                          int64_t i, bool robust,
                                          const Gnc& k, float s, float& c2,
                                          float& rho) {
  bool weighted = robust;
  if (i < in.n_pp) {
    float om[3][3], om_e[3];
    load_mat<3, 3>(in.pp_om + g * in.pp_om_stride + 9 * i, om);
    const PpError r = pp_error(in, poses, g, i);
    tvec(om, r.err, om_e);
    c2 = quad(r.err, om_e);
    weighted = weighted && !(k.closures_only && odometry(r.from, r.to));
  } else {
    const int64_t e = i - in.n_pp;
    float om[2][2], om_e[2];
    load_mat<2, 2>(in.pl_om + g * in.pl_om_stride + 4 * e, om);
    const PlError r = pl_error(in, poses, lms, g, e);
    tvec(om, r.err, om_e);
    c2 = quad(r.err, om_e);
  }
  rho = weighted ? gnc_rho(c2, s) : c2;
}

// A fixed tree over the CTA: within each warp, then the warps in order.
__device__ __forceinline__ float cta_sum(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = add(v, __shfl_down_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
#pragma unroll
    for (int w = 0; w < COST_THREADS / 32; ++w) s = add(s, scratch[w]);
  __syncthreads();
  return s;
}

// grid (graphs): one CTA a graph walks its edges, each thread every
// COST_THREADS-th edge in order, and writes chi2[g] = sum e^T W e at the
// graph's poses and, where rho is given, rho[g] = the sum of the costs; with
// cur_poses, rho_cur[g] = the sum of the costs at those poses (the current
// graph, which shares the measurements). The same order for both graphs, so
// equal poses give equal sums.
__global__ void __launch_bounds__(COST_THREADS)
se2_lm_cost(Inputs in, const float* __restrict__ cur_poses,
            const float* __restrict__ cur_lms, Gnc k, float d2,
            float* __restrict__ chi2, float* __restrict__ rho,
            float* __restrict__ rho_cur) {
  __shared__ float scratch[COST_THREADS / 32];
  const int64_t g = blockIdx.x;
  const bool robust = rho != nullptr;
  const float s = robust ? mul(gnc_mu(k, g), d2) : 0.f;
  const float* poses = in.poses + g * in.pose_stride;
  const float* lms = in.lms + g * in.lm_stride;
  float c2_sum = 0.f, rho_sum = 0.f, cur_sum = 0.f;
  for (int64_t i = threadIdx.x; i < in.n_pp + in.n_pl; i += COST_THREADS) {
    float c2, r;
    edge_cost(in, poses, lms, g, i, robust, k, s, c2, r);
    c2_sum = add(c2_sum, c2);
    rho_sum = add(rho_sum, r);
    if (cur_poses) {
      edge_cost(in, cur_poses + g * in.pose_stride,
                cur_lms + g * in.lm_stride, g, i, robust, k, s, c2, r);
      cur_sum = add(cur_sum, r);
    }
  }
  c2_sum = cta_sum(c2_sum, scratch);
  if (robust) rho_sum = cta_sum(rho_sum, scratch);
  if (cur_poses) cur_sum = cta_sum(cur_sum, scratch);
  if (threadIdx.x == 0) {
    chi2[g] = c2_sum;
    if (robust) rho[g] = rho_sum;
    if (cur_poses) rho_cur[g] = cur_sum;
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
// lam_stride, or null for lam_value everywhere. gnc 0: least squares
// (se2_edge_terms); 1: GNC Geman-McClure (se2_edge_terms_gnc) at mu (graphs,)
// at mu_stride and scale delta, or the scale s = mu_value where mu is null
// (delta 1), odometry at weight 1 where closures_only. Outputs, f32: vals (graphs, nnz) with the
// pose-landmark blocks at pl_base, the prior at prior_base and lambda at
// lam_base = nnz - n; b (graphs, n); chi2 (graphs,); scratch (graphs (6 E_pp
// + 5 E_pl + edge blocks)). Two kernel launches.
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
                      int64_t lam_stride, float lam_value, int gnc,
                      const float* mu, int64_t mu_stride, float mu_value,
                      float delta, int closures_only, float* vals,
                      int64_t nnz, float* b, float* chi2, float* scratch,
                      int64_t scratch_floats, void* stream) {
  const int64_t edges = n_pp + n_pl, n_parts = 6 * n_pp + 5 * n_pl;
  const int64_t edge_blocks = edges > 0 ? (edges + THREADS - 1) / THREADS : 1;
  const int64_t dof_blocks = n > 0 ? (n + THREADS - 1) / THREADS : 1;
  if (graphs < 1 || graphs > 65535 || n_pp < 0 || n_pl < 0 || n < 0 ||
      prior < 0 || prior > n || pl_base != 36 * n_pp ||
      prior_base != pl_base + 25 * n_pl || nnz != prior_base + prior + n ||
      edge_blocks > INT32_MAX || n_parts > INT32_MAX ||
      scratch_floats != graphs * (n_parts + edge_blocks) ||
      (gnc != 0 && gnc != 1))
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
  const dim3 edge_grid((unsigned)edge_blocks, (unsigned)graphs);
  if (gnc)
    se2_edge_terms_gnc<<<edge_grid, THREADS, 0, s>>>(
        in, pl_base, vals, nnz, parts, n_parts, partial,
        Gnc{mu, mu_stride, mu_value, delta, closures_only});
  else
    se2_edge_terms<<<edge_grid, THREADS, 0, s>>>(in, pl_base, vals, nnz,
                                                 parts, n_parts, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  se2_rhs_gather<<<dim3((unsigned)dof_blocks, (unsigned)graphs), THREADS, 0,
                   s>>>(ptr, src, parts, n_parts, partial, (int)edge_blocks,
                        n, prior, prior_base, prior_weight, lam, lam_stride,
                        lam_value, nnz - n, vals, nnz, b, chi2);
  return cudaGetLastError();
}

// LM's accept test for `graphs` same-structure SE2 graphs, in one launch:
// chi2 (graphs,) the sum of e^T W e at poses / lms (the trial); where rho is
// not null, rho (graphs,) the sum of the GNC Geman-McClure costs there at
// s = mu d2 (mu (graphs,) at mu_stride and d2 = delta^2, or mu_value = s
// where mu is null and d2 1; odometry quadratic where closures_only); where cur_poses is not null, rho_cur (graphs,) the same
// sum at cur_poses / cur_lms (the current graph, the poses' strides).
int se2_lm_cost_f32(int device, int graphs, const float* poses,
                    int64_t pose_stride, const float* lms, int64_t lm_stride,
                    const int64_t* pp_from, const int64_t* pp_to,
                    const float* pp_z, int64_t pp_z_stride,
                    const float* pp_om, int64_t pp_om_stride, int64_t n_pp,
                    const int64_t* pl_pose, const int64_t* pl_lm,
                    const float* pl_z, int64_t pl_z_stride,
                    const float* pl_om, int64_t pl_om_stride, int64_t n_pl,
                    const float* cur_poses, const float* cur_lms,
                    const float* mu, int64_t mu_stride, float mu_value,
                    float d2, int closures_only, float* chi2, float* rho,
                    float* rho_cur, void* stream) {
  if (graphs < 1 || n_pp < 0 || n_pl < 0 || (cur_poses && !rho) ||
      (cur_poses && !rho_cur))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Inputs in{poses,       lms,          pp_from,     pp_to,
                  pp_z,        pp_om,        pl_pose,     pl_lm,
                  pl_z,        pl_om,        pose_stride, lm_stride,
                  pp_z_stride, pp_om_stride, pl_z_stride, pl_om_stride,
                  n_pp,        n_pl};
  se2_lm_cost<<<(unsigned)graphs, COST_THREADS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      in, cur_poses, cur_lms, Gnc{mu, mu_stride, mu_value, 1.f, closures_only},
      d2, chi2, rho, rho_cur);
  return cudaGetLastError();
}

}  // extern "C"
