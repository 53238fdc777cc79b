// Banded inverse-Cholesky factorization (K1) and substitution (K2) for
// Hopper (sm_90a), IEEE f32 with FMA on the CUDA cores (no TF32: the 1e7
// gauge prior of the pose-graph systems needs full f32 products).
//
// K1 replaces rustrobotics_tpu/ops/band_chol_pallas.py::factorize_pallas
// (kernel _factor_kernel, helpers _blocked_chol_inv, _panel_chol_inv,
// _chol_inv_small). Sequential over block rows j of the RCM-banded system:
//     lp_j    = Lcoup_j ldinv_{j-1}^T        (lp_0 = 0)
//     D̂_j     = Dsym_j - lp_j lp_j^T
//     ldinv_j = chol(D̂_j)^-1
// What bounds it on an H100: the function needs ~2.7 kb^3 FLOP per block
// row (3.7e9 at kb=512, nb=11: 0.055 ms at the 67 TFLOP/s f32 peak), but
// it is a chain of dependent steps, each too small to fill 132 SMs: block
// row j needs ldinv_{j-1}, and inside a row the 128-wide diagonal panels
// follow one another. The running (kb, kb) block (1 MiB at kb=512) lives
// in global memory, where the 50 MB L2 keeps it. So the time is the
// latency of the chain: launches, barriers and the serial work of the one
// CTA that factors a diagonal panel. The design, per block row (np =
// kb/128), 2 + 2 np launches (10 at kb=512, from ~20):
//   1. gemm_nt: lp_j, skipping the zero k-tiles of the triangle
//      ldinv_{j-1}; 64x64 tiles (128x128 from kb=1024), a 4-stage
//      cp.async ring.
//   2. gemm_nt: D̂_j = Dsym_j - lp_j lp_j^T, lower tiles only, written
//      straight into the running block (Dsym_j is the beta operand; at
//      j = 0 it is the copy, and the same launch zeroes lp_0).
//   3. per diagonal panel i: panel_chol_inv factors and inverts the
//      128x128 block in registers (8x8 of A and of X = L^-1 a thread),
//      four 32-column sub-panels, each one warp-level [A11 | I] reduction
//      with shuffles (no CTA barrier inside) and one register-tiled
//      rank-32 update: two CTA barriers a sub-panel, 8 a panel (256 in the
//      shared-memory kernel it replaced).
//   4. after panel i, one launch, trail_offdiag, over a work list of the
//      whole fleet: strip items form each strip of UT rows of L[rest, i] =
//      A[rest, i] Linv_ii^T once a panel step, into lbuf (with the row
//      panel's zeros); update items, UT x UT lower tiles of the trailing
//      block, wait on their two strips' flags and subtract L L^T (UT 64,
//      4x4 outputs a thread, where the items fill the card; else 32, for
//      latency: trail_rows); side by side, CTAs form panel row i's
//      Linv[i, :i] = -Linv_ii (L[i, :i] Linv[:i, :i]), both products in one
//      CTA per 16-column tile through one ring of cp.async stages, the
//      zero rows of the triangle skipped.
// The panel kernel is the chain's critical part: each sub-panel's 32
// dependent steps of shuffles, an IEEE square root and reciprocal and
// FMAs are latency-bound.
// The earlier panel kernel ran the 128-step recursion in shared memory
// with two barriers a step; an 8-wide blocked variant of it in shared
// memory gained only 14%, as each thread's loads and FMAs formed a
// dependent chain: hence registers and warps. Every product sums over k in
// ascending order (the GEMMs one FMA chain per 32-deep k tile, the tiles
// added in order; the others one chain per output), so a result does not
// depend on the tile sizes.
//
// A fleet of B same-structure graphs runs as B chains side by side: every
// kernel takes a grid axis over the graphs (trail_offdiag the items of
// every graph in one list) and per-graph strides, so the host loop issues
// the same launches for all B. The per-graph arithmetic is that of B = 1,
// bit for bit (each output's sum order depends on kb alone).
//
// K2 replaces ...::substitute_pallas (kernels _fwd_kernel, _bwd_kernel):
//     y_j = ldinv_j (b_j - lp_j y_{j-1}),      j = 0 .. nb-1
//     x_j = ldinv_j^T (y_j - lp_{j+1}^T x_{j+1}), j = nb-1 .. 0
// What bounds it: two chains of nb dependent (kb, kb) GEMVs; the bytes
// (ldinv's lower triangles and lp_1.., ~1.5 nb kb^2 f32, 16 MB at kb=512,
// nb=11, ~5 us at 3.35 TB/s) bound it, the FLOPs do not; one SM cannot
// pull them at that rate, and 4 nb - 2 dependent steps each pay a
// cluster-wide barrier. The design: band_substitute, one launch for both
// sweeps, one cluster of CLUSTER CTAs per graph, a kernel for each kb (all
// index arithmetic constant). CTA q owns the index slice [q w, (q+1) w),
// w = kb / CLUSTER: in the forward sweep its rows of every block, in the
// backward sweep its columns, so lp^T and ldinv^T are read as row
// segments; the zero upper triangle of ldinv is skipped. Each CTA keeps
// the full vector a step reads in shared memory and writes its slice of
// the result into every CTA's copy through distributed shared memory; one
// cluster barrier a step, and the next step's first 16-byte loads are in
// flight across it (issued between the barrier's arrive and wait).
//
// Entry points have a plain C interface for ctypes. Each takes the
// device of its tensors (this library's runtime keeps its own current
// device, apart from PyTorch's) and returns the cudaError_t of its
// launches (0 on success).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <utility>

namespace cg = cooperative_groups;

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

namespace {

constexpr int PANEL = 128;        // diagonal panel width; kb is a multiple
constexpr int SUB = 32;           // sub-panel width of the panel kernel
constexpr int NSUB = PANEL / SUB;
constexpr int PANEL_THREADS = 256;
constexpr int GEMM_THREADS = 256; // 16 x 16 threads
constexpr int BK = 32;            // GEMM depth step
constexpr int GEMM_STAGES = 4;    // cp.async ring of the GEMM
constexpr int GLD = BK + 4;       // 144-byte rows: conflict-free float4 reads
constexpr int OT = 16;            // offdiag_inv column tile
constexpr int CLUSTER = 8;        // K2's CTAs a graph (the portable size)
constexpr int SUB_THREADS = 512;  // K2's threads a CTA: 16 warps
constexpr int PF = 8;             // K2's 16-byte loads a thread a round
constexpr int MAX_NF = 16;        // K2 takes kb up to 128 MAX_NF
constexpr int MAX_BATCH = 65535;  // grid y limit

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
template <int BM>
constexpr size_t gemm_smem() {
  return 2 * (size_t)GEMM_STAGES * BM * GLD * sizeof(float);
}

// C[m, n] = D[m, n] - A[m, :] B[n, :]^T (SUB_D) or A[m, :] B[n, :]^T,
// every matrix (kb, kb) row-major at graph stride sa, sb, sd, sc (graph
// blockIdx.y). BM x BM tiles, (BM/16)^2 outputs a thread, a ring of
// GEMM_STAGES BK-deep tiles of A and B filled by cp.async (dynamic shared
// memory, gemm_smem<BM>() bytes). LOWER: only the
// tiles with tm >= tn (blockIdx.x enumerates them), and z, if not null,
// gets zeros in tile (tm, tn) and its mirror. TRI_B: B is lower
// triangular, so the k-range of a tile ends at n0 + BM. Each BK-deep k
// tile sums into a fresh FMA chain and the tiles' sums add from k = 0 up
// (at most K): a two-level sum, whose rounding error grows with BK + K/BK
// terms rather than K. D̂ = Dsym - lp lp^T cancels to a Schur complement
// that is near singular in f32 on long pose chains, and on chip_smoke's
// jittered fleet this brought K1's LM closer to the plain chain's than
// one K-long chain per output did.
template <int BM, bool LOWER, bool TRI_B, bool SUB_D>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_nt(int kb, int K, const float* __restrict__ A, size_t sa,
        const float* __restrict__ B, size_t sb, const float* __restrict__ D,
        size_t sd, float* __restrict__ C, size_t sc, float* __restrict__ z,
        size_t sz, unsigned* __restrict__ clr, size_t nclr) {
  constexpr int TM = BM / 16;
  extern __shared__ __align__(16) float gsm[];
  float* As = gsm;                          // GEMM_STAGES x BM x GLD
  float* Bs = gsm + GEMM_STAGES * BM * GLD;
  const size_t g = blockIdx.y;
  A += g * sa;
  B += g * sb;
  C += g * sc;
  int tm, tn;
  if (LOWER) {
    int t = blockIdx.x;
    tm = 0;
    while (t > tm) t -= ++tm;
    tn = t;
  } else {
    const int nt = kb / BM;
    tm = blockIdx.x / nt;
    tn = blockIdx.x % nt;
  }
  const int m0 = tm * BM, n0 = tn * BM;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nk = (TRI_B ? min(K, n0 + BM) : K) / BK;  // kb is a multiple of BK
  auto load = [&](int stage, int k0) {
#pragma unroll
    for (int u = 0; u < BM * BK / 4 / GEMM_THREADS; ++u) {
      const int l = tid + u * GEMM_THREADS;
      const int r = l / (BK / 4), c = (l % (BK / 4)) * 4;
      cp_async16(As + (stage * BM + r) * GLD + c,
                 A + (size_t)(m0 + r) * kb + k0 + c);
      cp_async16(Bs + (stage * BM + r) * GLD + c,
                 B + (size_t)(n0 + r) * kb + k0 + c);
    }
  };
  float acc[TM][TM] = {};
#pragma unroll
  for (int t = 0; t < GEMM_STAGES - 1; ++t) {
    if (t < nk) load(t, t * BK);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<GEMM_STAGES - 2>();
    // also orders the reads of the stage loaded next (tile t - 1) first
    __syncthreads();
    if (t + GEMM_STAGES - 1 < nk)
      load((t + GEMM_STAGES - 1) % GEMM_STAGES, (t + GEMM_STAGES - 1) * BK);
    cp_async_commit();
    const float* as = As + (t % GEMM_STAGES) * BM * GLD;
    const float* bs = Bs + (t % GEMM_STAGES) * BM * GLD;
    float part[TM][TM] = {};
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float4 a[TM], b[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * GLD + k4);
#pragma unroll
      for (int j = 0; j < TM; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * GLD + k4);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) {
          part[i][j] = fmaf(a[i].x, b[j].x, part[i][j]);
          part[i][j] = fmaf(a[i].y, b[j].y, part[i][j]);
          part[i][j] = fmaf(a[i].z, b[j].z, part[i][j]);
          part[i][j] = fmaf(a[i].w, b[j].w, part[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) acc[i][j] += part[i][j];
  }
  if (SUB_D) D += g * sd;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const size_t o = (size_t)(m0 + ty + 16 * i) * kb + n0 + tx + 16 * j;
      C[o] = SUB_D ? D[o] - acc[i][j] : acc[i][j];
    }
  if (LOWER && z != nullptr) {
    z += g * sz;
    for (int l = tid; l < BM * BM; l += GEMM_THREADS) {
      const int r = l / BM, c = l % BM;
      z[(size_t)(m0 + r) * kb + n0 + c] = 0.f;
      z[(size_t)(n0 + r) * kb + m0 + c] = 0.f;
    }
  }
  if (clr != nullptr) {
    const size_t cta = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    const size_t step = (size_t)gridDim.x * gridDim.y * GEMM_THREADS;
    for (size_t l = cta * GEMM_THREADS + tid; l < nclr; l += step) clr[l] = 0u;
  }
}

// Shared buffers of panel_chol_inv, in floats.
constexpr int LDA = SUB + 4;  // 144-byte rows: 16-byte broadcast reads
constexpr int PB_ACOL = PANEL * LDA;          // A[:, c0:c0+SUB]
constexpr int PB_XST = PANEL * LDA;           // X[S, :]^T
constexpr int PB_LC = PANEL * LDA;            // L21
constexpr int PB_XN = PANEL * LDA;            // (Linv11 X[S, :])^T
constexpr size_t PANEL_SMEM =
    (size_t)(PB_ACOL + PB_XST + PB_LC + PB_XN) * sizeof(float);
constexpr int FACTOR_WARPS = 4;  // each factors [A11 | I], then a share of the dots

// A pivot's scale 1/sqrt(d) as LAPACK's potf2 forms it: the IEEE square
// root, then the IEEE reciprocal (NaN for a negative pivot). Two other
// forms were tried on the H100 and rejected: the hardware estimate
// refined by one Newton step sits below 1/sqrt(d) on average, a bias
// that kept pivots but left GN on chip_smoke's jittered fleet short of
// convergence in 10 steps, and the correctly rounded __frsqrt_rn lost
// pivots on the front end's band that this form and the library keep.
__device__ __forceinline__ float inv_sqrt(float d) {
  return __frcp_rn(__fsqrt_rn(d));
}

// acc -= a . b, in order
__device__ __forceinline__ void fma4(float& acc, float4 a, float4 b) {
  acc = fmaf(-a.x, b.x, acc);
  acc = fmaf(-a.y, b.y, acc);
  acc = fmaf(-a.z, b.z, acc);
  acc = fmaf(-a.w, b.w, acc);
}

// The rank-32 update of sub-panel S on thread (tr, tc)'s registers:
// A[R, R] -= L21 L21^T on the lower 32-blocks and X[R, :c0+32] -= L21 XS'
// for the rows R below the sub-panel (i / 2 > S). lc[r * LDA + k] =
// L21[r, k] and xnt[c * LDA + k] = XS'[k, c] are read four k at a time
// (16-byte reads); each output still sums k in order. S is a template
// argument, so only the FMAs of live blocks are issued.
template <int S>
__device__ __forceinline__ void rank32_update(float (&A)[8][8],
                                              float (&X)[8][8],
                                              const float* lc,
                                              const float* xnt, int tr,
                                              int tc) {
#pragma unroll 2
  for (int k = 0; k < SUB; k += 4) {
    float4 lr[8], lcv[8], xv[8];
#pragma unroll
    for (int i = 2 * (S + 1); i < 8; ++i)
      lr[i] = *reinterpret_cast<const float4*>(lc + (tr + 16 * i) * LDA + k);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j / 2 > S)
        lcv[j] = *reinterpret_cast<const float4*>(lc + (tc + 16 * j) * LDA + k);
      if (j / 2 <= S)
        xv[j] = *reinterpret_cast<const float4*>(xnt + (tc + 16 * j) * LDA + k);
    }
#pragma unroll
    for (int i = 2 * (S + 1); i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j / 2 > S && j / 2 <= i / 2) fma4(A[i][j], lr[i], lcv[j]);
        if (j / 2 <= S) fma4(X[i][j], lr[i], xv[j]);
      }
  }
}

// One CTA a graph (blockIdx.x): the (PANEL, PANEL) SPD block at a (its
// lower 32-blocks read) -> its inverse Cholesky factor at linv, zeros
// above the diagonal. Thread (tr, tc) keeps A and X = L^-1 at rows tr + 16 i
// and columns tc + 16 j (i, j < 8) in registers. Sub-panel s (columns
// c0 = 32 s ..): its column block of A and its rows of X go to shared
// memory; barrier; FACTOR_WARPS warps each reduce [A11 | I] (32 x 32,
// lane = row, row k read through shuffles) to Linv11 and form their share
// of L21 = A21 Linv11^T and XS' = Linv11 X[S, :] (16-byte broadcast reads);
// barrier; every thread applies the rank-32 update A22 -= L21 L21^T (lower
// 32-blocks only) and X[R, :] -= L21 XS' to its registers and takes XS'
// for its rows of S.
__global__ void __launch_bounds__(PANEL_THREADS, 1)
panel_chol_inv(int kb, const float* __restrict__ a, size_t sa,
               float* __restrict__ linv, size_t sl) {
  a += blockIdx.x * sa;
  linv += blockIdx.x * sl;
  extern __shared__ __align__(16) float smem[];
  float* acol = smem;                  // acol[r * LDA + p] = A[r, c0 + p]
  float* xst = acol + PB_ACOL;         // xst[c * LDA + p] = X[c0 + p, c]
  float* lc = xst + PB_XST;            // lc[r * LDA + p] = L21[r, p]
  float* xnt = lc + PB_LC;             // xnt[c * LDA + p] = XS'[p, c]
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  float A[8][8], X[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tr + 16 * i, c = tc + 16 * j;
      A[i][j] = (j / 2 <= i / 2) ? a[(size_t)r * kb + c] : 0.f;
      X[i][j] = (r == c) ? 1.f : 0.f;
    }
  for (int s = 0; s < NSUB; ++s) {
    const int c0 = s * SUB;
    // row and column 32-blocks of register (i, j) are i / 2 and j / 2
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tr + 16 * i, c = tc + 16 * j;
        if (i / 2 >= s && j / 2 == s) acol[r * LDA + c - c0] = A[i][j];
        if (i / 2 == s && j / 2 <= s) xst[c * LDA + r - c0] = X[i][j];
      }
    __syncthreads();
    if (warp < FACTOR_WARPS) {
      float la[SUB], lx[SUB];
#pragma unroll
      for (int p = 0; p < SUB; ++p) {
        la[p] = (p <= lane) ? acol[(c0 + lane) * LDA + p]
                            : acol[(c0 + p) * LDA + lane];
        lx[p] = (p == lane) ? 1.f : 0.f;
      }
      // A step is one Cholesky pivot: s = inv_sqrt(A[k, k]), one rounded
      // value that scales both row k of [A | X] (the column of L below the
      // pivot, by symmetry, and X's row k), and the rows below subtract
      // l_r (s row k), l_r = A[r, k] s: the update is the exact product of
      // kept factor entries, as in LAPACK's potf2, which scales its
      // column by one rounded 1/L[k, k]. Unscaled (LDL^T) steps, which
      // update with 1 / A[k, k] and scale X with 1 / sqrt(A[k, k]), two
      // roundings of one pivot, lose pivots on chip_smoke's front-end band
      // (a Schur complement chain near singular in f32) partway down the
      // chain, where the plain chain keeps them. Two
      // steps k, k + 1 at a time: rows k and k + 1 are read through
      // shuffles as they stand before step k, and every lane forms row
      // k + 1 after step k itself (the same FMAs lane k + 1 does), so a
      // pair pays one shuffle latency. Every lane takes the same scale
      // and selects: no branch on the chain but the IEEE operations' own.
      float own = 1.f;
#pragma unroll
      for (int k = 0; k < SUB; k += 2) {
        float r0[SUB], r1[SUB];
        const float d0 = __shfl_sync(0xffffffffu, la[k], k);
#pragma unroll
        for (int p = 0; p < SUB; ++p) {
          r0[p] = __shfl_sync(0xffffffffu, p > k ? la[p] : lx[p], k);
          r1[p] = __shfl_sync(0xffffffffu, p > k ? la[p] : lx[p], k + 1);
        }
        const float s0 = inv_sqrt(d0);
#pragma unroll
        for (int p = 0; p < SUB; ++p) r0[p] *= s0;
        // l_{k+1} = A[k + 1, k] s0 = r0[k + 1] (the block is symmetric bit
        // for bit: only its lower triangle is read, and fmaf commutes)
        const float l10 = r0[k + 1];
#pragma unroll
        for (int p = 0; p < SUB; ++p) r1[p] = fmaf(-l10, r0[p], r1[p]);
        const float s1 = inv_sqrt(r1[k + 1]);
#pragma unroll
        for (int p = 0; p < SUB; ++p) r1[p] *= s1;
        own = (lane == k) ? s0 : (lane == k + 1) ? s1 : own;
        const float lr0 = (lane > k) ? la[k] * s0 : 0.f;
#pragma unroll
        for (int p = 0; p < SUB; ++p) {
          if (p > k)
            la[p] = fmaf(-lr0, r0[p], la[p]);
          else
            lx[p] = fmaf(-lr0, r0[p], lx[p]);
        }
        const float lr1 = (lane > k + 1) ? la[k + 1] * s1 : 0.f;
#pragma unroll
        for (int p = 0; p < SUB; ++p) {
          if (p > k + 1)
            la[p] = fmaf(-lr1, r1[p], la[p]);
          else if (p <= k)
            lx[p] = fmaf(-lr1, r1[p], lx[p]);
          else  // X[k + 1, k + 1] = 1 before its scaling: s1 after
            lx[p] = fmaf(-lr1, s1, lx[p]);
        }
      }
      // a lane's row of X was used scaled by its own s (r0, r1 above)
#pragma unroll
      for (int p = 0; p < SUB; ++p) lx[p] *= own;
      // lane q holds row q of Linv11 in lx (zeros above the diagonal)
      auto dot = [&](const float* v) {
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < SUB; p += 4) {
          const float4 x = *reinterpret_cast<const float4*>(v + p);
          acc = fmaf(x.x, lx[p], acc);
          acc = fmaf(x.y, lx[p + 1], acc);
          acc = fmaf(x.z, lx[p + 2], acc);
          acc = fmaf(x.w, lx[p + 3], acc);
        }
        return acc;
      };
#pragma unroll 4
      for (int r = c0 + SUB + warp; r < PANEL; r += FACTOR_WARPS)
        lc[r * LDA + lane] = dot(acol + r * LDA);
#pragma unroll 4
      for (int c = warp; c < c0 + SUB; c += FACTOR_WARPS)
        xnt[c * LDA + lane] = dot(xst + c * LDA);
    }
    __syncthreads();
    switch (s) {
      case 0: rank32_update<0>(A, X, lc, xnt, tr, tc); break;
      case 1: rank32_update<1>(A, X, lc, xnt, tr, tc); break;
      case 2: rank32_update<2>(A, X, lc, xnt, tr, tc); break;
      default: break;  // the last sub-panel has no rows below it
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i / 2 == s && j / 2 <= s)
          X[i][j] = xnt[(tc + 16 * j) * LDA + tr + 16 * i - c0];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = tr + 16 * i, c = tc + 16 * j;
      linv[(size_t)r * kb + c] = (c <= r) ? X[i][j] : 0.f;
    }
}

// The trailing update after diagonal panel i (at column o) works on the
// rows r0 = o + PANEL .. kb in strips of UT rows. A strip item forms
// L[strip, i] = a[strip, o:o+PANEL] Linv_ii^T once, into lbuf; an update
// item takes a lower UT x UT tile (tm, tn) of a[r0:, r0:] and subtracts
// L_tm L_tn^T there, reading the two strips from lbuf. Both hold their
// operands row-major in shared memory, a row's PANEL k-values at stride
// LDS (33 16-byte groups: the 16-byte reads of a quarter warp's 8 rows
// hit 8 bank groups), loaded by cp.async in NSUB groups of SUB k, so the
// FMAs on one group run while the next lands. Thread (ty, tx) of 16 x 16
// holds rows ty + 16 i (i < UT / 16) and columns tx + 16 j of its outputs:
// 4x4 an update tile at UT = 64, 2x2 at UT = 32.
constexpr int LDS = PANEL + 4;
constexpr int MIN_UT = 32;
// offdiag_tile's ring: OSTAGES stages of PANEL rows x SUB k of A and SUB
// k-rows x OT of B; T (PANEL x LDB_O) fills the B stages exactly.
constexpr int OSTAGES = 4;
constexpr int LDA_O = SUB + 4;
constexpr int LDB_O = OT + 4;
static_assert(OSTAGES * SUB == PANEL, "T takes the B stages' place");
constexpr size_t OFFDIAG_SMEM =
    (size_t)OSTAGES * (PANEL * LDA_O + SUB * LDB_O) * sizeof(float);
template <int UT>
constexpr size_t trail_smem() {
  return std::max({(UT + PANEL) * LDS * sizeof(float),  // a strip
                   2 * UT * LDS * sizeof(float),          // an update tile
                   OFFDIAG_SMEM});
}

// UT of a call, from the first panel step's work list and the card's
// resident CTAs (fill, TRAIL_CTAS an SM): 64 where its 64x64 update tiles
// over the fleet fill the card, or where one graph's 32-row items (strips
// and tiles) alone do, else 32. Where the items are few, a step's time is
// the latency of its two dependent phases (a strip, then a tile), which
// shorter strips and tiles cut. On an H100 (fill 264) the rule gives the
// faster height at every shape timed with both: 32 at kb 384, B 1 and at
// kb 512, B 1 and 8; 64 at kb 512, B 16 and 32 and at kb 1024, B 1 and 8.
constexpr int TRAIL_CTAS = 2;
int trail_rows(int kb, int batch, long long fill) {
  const long long t64 = (kb - PANEL) / 64, t32 = (kb - PANEL) / 32;
  const bool fleet_fills = batch * (t64 * (t64 + 1) / 2) >= fill;
  const bool graph_fills = t32 + t32 * (t32 + 1) / 2 >= fill;
  return fleet_fills || graph_fills ? 64 : 32;
}

// Rows [r_lo, r_hi) of src (row stride kb), k-columns [SUB q, SUB q + SUB),
// into dst at stride LDS, 16 bytes a cp.async, by a CTA of 256 threads.
__device__ __forceinline__ void stage_k(float* dst, const float* src, int kb,
                                        int r_lo, int r_hi, int q) {
  constexpr int G = SUB / 4;  // 16-byte groups a row
  for (int l = threadIdx.x; l < (r_hi - r_lo) * G; l += 256) {
    const int r = r_lo + l / G, c = SUB * q + (l % G) * 4;
    cp_async16(dst + r * LDS + c, src + (size_t)r * kb + c);
  }
}

// k-group Q of a strip: acc[i][j] += a[r, k] Linv_ii[c, k] for k in
// [SUB Q, SUB Q + SUB), in order, on the columns c = tx + 16 j whose
// 32-column block j / 2 reaches that far (j / 2 >= Q).
template <int TI, int Q>
__device__ __forceinline__ void strip_group(float (&acc)[TI][8],
                                            const float* as, const float* ls,
                                            int ty, int tx) {
  cp_async_wait<NSUB - 1 - Q>();
  __syncthreads();
#pragma unroll 2
  for (int k = SUB * Q; k < SUB * (Q + 1); k += 4) {
    float4 x[TI], y[8];
#pragma unroll
    for (int i = 0; i < TI; ++i)
      x[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * LDS + k);
#pragma unroll
    for (int j = 2 * Q; j < 8; ++j)
      y[j] = *reinterpret_cast<const float4*>(ls + (tx + 16 * j) * LDS + k);
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 2 * Q; j < 8; ++j) {
        acc[i][j] = fmaf(x[i].x, y[j].x, acc[i][j]);
        acc[i][j] = fmaf(x[i].y, y[j].y, acc[i][j]);
        acc[i][j] = fmaf(x[i].z, y[j].z, acc[i][j]);
        acc[i][j] = fmaf(x[i].w, y[j].w, acc[i][j]);
      }
  }
}

// Strip s: L[r, c] = sum_k a[r, o + k] Linv_ii[c, k] for its UT rows and
// the PANEL columns, one FMA chain a value from k = 0 up to the end of
// c's 32-column block (Linv_ii is lower triangular), into lbuf; then the
// row panel's zeros above the diagonal in these rows' columns of linv.
template <int UT>
__device__ __forceinline__ void strip_item(int kb, int o, int s,
                                           const float* __restrict__ a,
                                           float* __restrict__ linv,
                                           float* __restrict__ lbuf,
                                           float* smem) {
  constexpr int TI = UT / 16;
  float* as = smem;           // UT x LDS: as[r * LDS + k] = a[r0 + r, o + k]
  float* ls = as + UT * LDS;  // PANEL x LDS: ls[c * LDS + k] = Linv_ii[c, k]
  const int r0 = o + PANEL + UT * s;
#pragma unroll
  for (int q = 0; q < NSUB; ++q) {
    stage_k(as, a + (size_t)r0 * kb + o, kb, 0, UT, q);
    // Linv_ii[c, k] = 0 for k > c: group q is read by rows c >= SUB q
    stage_k(ls, linv + (size_t)o * kb + o, kb, SUB * q, PANEL, q);
    cp_async_commit();
  }
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[TI][8] = {};
  strip_group<TI, 0>(acc, as, ls, ty, tx);
  strip_group<TI, 1>(acc, as, ls, ty, tx);
  strip_group<TI, 2>(acc, as, ls, ty, tx);
  strip_group<TI, 3>(acc, as, ls, ty, tx);
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      lbuf[(size_t)(r0 + ty + 16 * i) * kb + o + tx + 16 * j] = acc[i][j];
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = tid; l < PANEL * UT / 4; l += 256)
    *reinterpret_cast<float4*>(linv + (size_t)(o + l / (UT / 4)) * kb + r0 +
                               4 * (l % (UT / 4))) = zero;
}

// k-group Q of an update tile: acc[i][j] -= L_m[k] L_n[k] in order.
template <int TI, int Q>
__device__ __forceinline__ void update_group(float (&acc)[TI][TI],
                                             const float* ms, const float* ns,
                                             int ty, int tx) {
  cp_async_wait<NSUB - 1 - Q>();
  __syncthreads();
#pragma unroll 2
  for (int k = SUB * Q; k < SUB * (Q + 1); k += 4) {
    float4 x[TI], y[TI];
#pragma unroll
    for (int i = 0; i < TI; ++i)
      x[i] = *reinterpret_cast<const float4*>(ms + (ty + 16 * i) * LDS + k);
#pragma unroll
    for (int j = 0; j < TI; ++j)
      y[j] = *reinterpret_cast<const float4*>(ns + (tx + 16 * j) * LDS + k);
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TI; ++j) fma4(acc[i][j], x[i], y[j]);
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Update tile t (lower, tm >= tn) of the UT x UT tiles of a[r0:, r0:]:
// once strips tm and tn are in lbuf (their flags read stamp), a[m, n] -=
// sum_k L[m, k] L[n, k], one FMA chain an element from a[m, n] over k = 0
// .. PANEL - 1 in order. A diagonal tile at UT = 64 also writes its upper
// 32-block, which nothing reads.
template <int UT>
__device__ __forceinline__ void update_item(int kb, int o, int t,
                                            float* __restrict__ a,
                                            const float* lbuf,
                                            const unsigned* flags,
                                            unsigned stamp, float* smem) {
  constexpr int TI = UT / 16;
  int tm = 0;
  while (t > tm) t -= ++tm;
  const int tn = t;
  const int m0 = o + PANEL + UT * tm, n0 = o + PANEL + UT * tn;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[TI][TI];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j)
      acc[i][j] = a[(size_t)(m0 + ty + 16 * i) * kb + n0 + tx + 16 * j];
  if (tid == 0) {  // polls that back off leave L2 and the SM to the strips
    while (load_acquire(flags + tm) != stamp) __nanosleep(64);
    while (load_acquire(flags + tn) != stamp) __nanosleep(64);
  }
  __syncthreads();
  float* ms = smem;  // ms[r * LDS + k] = L[m0 + r, k]
  float* ns = tm == tn ? ms : ms + UT * LDS;
#pragma unroll
  for (int q = 0; q < NSUB; ++q) {
    stage_k(ms, lbuf + (size_t)m0 * kb + o, kb, 0, UT, q);
    if (tm != tn) stage_k(ns, lbuf + (size_t)n0 * kb + o, kb, 0, UT, q);
    cp_async_commit();
  }
  update_group<TI, 0>(acc, ms, ns, ty, tx);
  update_group<TI, 1>(acc, ms, ns, ty, tx);
  update_group<TI, 2>(acc, ms, ns, ty, tx);
  update_group<TI, 3>(acc, ms, ns, ty, tx);
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TI; ++j)
      a[(size_t)(m0 + ty + 16 * i) * kb + n0 + tx + 16 * j] = acc[i][j];
}

// Panel row i of ldinv_j (rows o = i PANEL), column tile ct of width OT
// (columns c0 = OT ct ..): T = L[o:o+PANEL, c0:o] Linv[c0:o, c0:c0+OT]
// (the triangle Linv[:o, :o] is zero above row c0 in these columns), then
// Linv[o:o+PANEL, c0:c0+OT] = -Linv_ii T, the zero upper triangle of
// Linv_ii skipped a 16-row band at a time (row r's sum ends at
// 16 (r / 16) + 16). Each output is one FMA chain over k ascending. The A
// operands, L's rows of the panel row and then Linv_ii, stream through a
// ring of OSTAGES cp.async stages of SUB k-columns, row-major (stride
// LDA_O: the 16-byte reads of a warp's 8 rows hit 8 bank groups); Linv's
// rows of the first product ride the same stages, and T takes their place
// for the second. Thread (ty, tx) of 64 x 4: rows ty, ty + 64, columns
// c0 + 4 tx .. + 3.
__device__ __forceinline__ void offdiag_tile(int kb, int o, int ct,
                                             float* __restrict__ linv,
                                             const float* __restrict__ lbuf,
                                             float* smem) {
  float* as = smem;                            // OSTAGES x PANEL x LDA_O
  float* bs = as + OSTAGES * PANEL * LDA_O;    // OSTAGES x SUB x LDB_O
  float* ts = bs;                              // then T: PANEL x LDB_O
  const int c0 = ct * OT, k0 = c0 / SUB * SUB;
  const int n1 = (o - k0) / SUB, n = n1 + NSUB;  // k-groups of each product
  const int tid = threadIdx.x, tx = tid % 4, ty = tid / 4;
  auto load = [&](int t) {
    float* a = as + (t % OSTAGES) * PANEL * LDA_O;
    const float* src = t < n1 ? lbuf + (size_t)o * kb + k0 + SUB * t
                              : linv + (size_t)o * kb + o + SUB * (t - n1);
#pragma unroll
    for (int u = 0; u < PANEL * SUB / 4 / 256; ++u) {
      const int l = tid + 256 * u, r = l / (SUB / 4), c = (l % (SUB / 4)) * 4;
      cp_async16(a + r * LDA_O + c, src + (size_t)r * kb + c);
    }
    if (t < n1 && tid < SUB * OT / 4) {
      const int r = tid / (OT / 4), c = (tid % (OT / 4)) * 4;
      cp_async16(bs + ((t % OSTAGES) * SUB + r) * LDB_O + c,
                 linv + (size_t)(k0 + SUB * t + r) * kb + c0 + c);
    }
  };
  // acc[i][q] += x[i][k] y[k][q] over k of [k_lo, SUB), x the rows of A
  // (only those with k < kend[i] in the second product), y a k-row of B
  float acc[2][4] = {};
  auto group = [&](const float* a, const float* b, int k_lo,
                   const int (&kend)[2]) {
#pragma unroll 2
    for (int k = k_lo; k < SUB; k += 4) {
      float4 x[2], y[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        x[i] = *reinterpret_cast<const float4*>(a + (ty + 64 * i) * LDA_O + k);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        y[q] = *reinterpret_cast<const float4*>(b + (k + q) * LDB_O + 4 * tx);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (k >= kend[i]) continue;
        const float xv[4] = {x[i].x, x[i].y, x[i].z, x[i].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][0] = fmaf(xv[q], y[q].x, acc[i][0]);
          acc[i][1] = fmaf(xv[q], y[q].y, acc[i][1]);
          acc[i][2] = fmaf(xv[q], y[q].z, acc[i][2]);
          acc[i][3] = fmaf(xv[q], y[q].w, acc[i][3]);
        }
      }
    }
  };
#pragma unroll
  for (int t = 0; t < OSTAGES - 1; ++t) {
    if (t < n) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_async_wait<OSTAGES - 2>();
    // also orders the reads of the stage loaded next (group t - 1) first
    __syncthreads();
    if (t + OSTAGES - 1 < n) load(t + OSTAGES - 1);
    cp_async_commit();
    const float* a = as + (t % OSTAGES) * PANEL * LDA_O;
    if (t < n1) {
      const int all[2] = {SUB, SUB};
      group(a, bs + (t % OSTAGES) * SUB * LDB_O, t == 0 ? c0 - k0 : 0, all);
      if (t == n1 - 1) {
        __syncthreads();  // every read of B's stages done: T takes them
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          *reinterpret_cast<float4*>(ts + (ty + 64 * i) * LDB_O + 4 * tx) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;
        }
      }
    } else {
      const int p0 = SUB * (t - n1);
      int kend[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        kend[i] = (ty + 64 * i) / 16 * 16 + 16 - p0;
      group(a, ts + p0 * LDB_O, 0, kend);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    *reinterpret_cast<float4*>(linv + (size_t)(o + ty + 64 * i) * kb + c0 +
                               4 * tx) =
        make_float4(-acc[i][0], -acc[i][1], -acc[i][2], -acc[i][3]);
}

// The launch after diagonal panel i (at column o), one CTA an item of a
// work list over the fleet, in order: every graph's strips (strip_item),
// every graph's column tiles of panel row i's off-diagonal inverse
// (offdiag_tile, i >= 1), every graph's lower update tiles (update_item).
// A CTA takes the next item from the launch's ticket, so every strip is
// claimed, by a running CTA, before any update tile; a strip CTA, which
// waits on nothing, publishes its strip with a release store of stamp to
// its flag, and an update tile acquires the flags of its two strips. So
// no CTA waits on work that is not under way. The strips and the
// off-diagonal tiles read what earlier launches wrote and write disjoint
// parts of lbuf and linv. flags: sf a graph, strip s at s.
template <int UT>
__global__ void __launch_bounds__(256, TRAIL_CTAS)
trail_offdiag(int kb, int o, int n_strip, int n_off, int batch,
              float* __restrict__ a, size_t sa, float* __restrict__ linv,
              size_t sl, float* __restrict__ lbuf, size_t sw,
              unsigned* ticket, unsigned* flags, int sf, unsigned stamp) {
  extern __shared__ __align__(16) float smem[];
  __shared__ unsigned claimed;
  if (threadIdx.x == 0) claimed = atomicAdd(ticket, 1u);
  __syncthreads();
  unsigned item = claimed;
  const unsigned strips = (unsigned)batch * n_strip;
  const unsigned offs = (unsigned)batch * n_off;
  if (item < strips) {
    const size_t g = item / n_strip;
    const int s = item % n_strip;
    strip_item<UT>(kb, o, s, a + g * sa, linv + g * sl, lbuf + g * sw, smem);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      store_release(flags + g * sf + s, stamp);
    }
  } else if ((item -= strips) < offs) {
    const size_t g = item / n_off;
    offdiag_tile(kb, o, item % n_off, linv + g * sl, lbuf + g * sw, smem);
  } else {
    item -= offs;
    const unsigned n_upd = n_strip * (n_strip + 1) / 2;
    const size_t g = item / n_upd;
    update_item<UT>(kb, o, item % n_upd, a + g * sa, lbuf + g * sw,
                    flags + g * sf, stamp, smem);
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// K2's geometry at kb = 128 NF. CTA q of a graph's cluster owns the
// indices [lo, lo + W), lo = q W: the rows of M v, the columns of M^T v.
// A round is PF 16-byte loads a thread, issued one round ahead of the
// FMAs that use them.
template <int NF>
struct Sub {
  static constexpr int KB = 128 * NF;
  static constexpr int W = KB / CLUSTER;  // 16 NF
  // M v: warp w takes rows lo + w + 16 u (u < NF), lane l the 16-byte
  // groups l + 32 fc (fc < NF) of a row. Round rd is the rows u = rg R ..
  // of row group rg = rd / NC and the groups fc = cc CF .. of chunk cc =
  // rd % NC; its item e is (rg R + e / CF, cc CF + e % CF).
  static constexpr int CF = NF >= 8 ? 8 : NF >= 3 ? 4 : NF;
  static constexpr int R = PF / CF;
  static constexpr int NC = (NF + CF - 1) / CF;
  static constexpr int ROW_ROUNDS = (NF + R - 1) / R * NC;
  // M^T v: SEG threads a row segment (16-byte groups f), G row groups;
  // thread (gi, f) takes rows r0 + gi + G u, round rd the u = rd PF ..
  static constexpr int SEG = W / 4;
  static constexpr int G = SUB_THREADS / SEG;
  static constexpr int COL_ROUNDS = (KB + G * PF - 1) / (G * PF);
  // threads a column in the reduction of the G partial sums: a power of
  // two with T W <= SUB_THREADS (T W is then a multiple of 32)
  static constexpr int T = 32 * W <= SUB_THREADS   ? 32
                           : 16 * W <= SUB_THREADS ? 16
                           : 8 * W <= SUB_THREADS  ? 8
                           : 4 * W <= SUB_THREADS  ? 4
                                                   : 2;
};

// Round rd of M v into buf: zeros for the items past the row's end and,
// when TRI (M lower triangular), for the groups above the diagonal.
template <int NF, bool TRI>
__device__ __forceinline__ void rows_load(const float* __restrict__ m, int rd,
                                          float4 (&buf)[PF], int lo) {
  using S = Sub<NF>;
  const int lane = threadIdx.x % 32, row0 = lo + threadIdx.x / 32;
  const float4* base =
      reinterpret_cast<const float4*>(m + (size_t)row0 * S::KB) + lane;
  const int rg = rd / S::NC, cc = rd % S::NC;
#pragma unroll
  for (int e = 0; e < PF; ++e) {
    const int u = rg * S::R + e / S::CF, fc = cc * S::CF + e % S::CF;
    const bool ok = u < NF && fc < NF &&
                    (!TRI || 4 * (lane + 32 * fc) <= row0 + 16 * u);
    buf[e] = ok ? __ldg(base + (size_t)u * 4 * S::KB + 32 * fc)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int NF, bool TRI>
__device__ __forceinline__ void cols_load(const float* __restrict__ m, int rd,
                                          float4 (&buf)[PF], int lo) {
  using S = Sub<NF>;
  const int gi = threadIdx.x / S::SEG, f = threadIdx.x % S::SEG;
  const int r0 = (TRI ? lo : 0) + gi;
  const float4* base =
      reinterpret_cast<const float4*>(m + (size_t)r0 * S::KB + lo) + f;
#pragma unroll
  for (int e = 0; e < PF; ++e) {
    const int u = rd * PF + e;
    const bool ok = gi < S::G && r0 + S::G * u < S::KB;
    buf[e] = ok ? __ldg(base + (size_t)u * S::G * S::KB / 4)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Round rd of M v: the next round's loads into nxt, this round's FMAs on
// cur (per-item partial sums in s); at the end of a row group each row's
// sum (items in order, then across the warp) goes, minus from rhs, into
// dst of every CTA of the cluster, and into out.
template <int NF, bool TRI>
__device__ __forceinline__ void rows_round(
    const cg::cluster_group& cluster, const float* __restrict__ m,
    const float* rhs, float* out, const float* v, float* dst, int lo, int rd,
    const float4 (&cur)[PF], float4 (&nxt)[PF], float (&s)[PF]) {
  using S = Sub<NF>;
  if (rd + 1 < S::ROW_ROUNDS) rows_load<NF, TRI>(m, rd + 1, nxt, lo);
  const int lane = threadIdx.x % 32;
  const float4* v4 = reinterpret_cast<const float4*>(v) + lane;
  const int rg = rd / S::NC, cc = rd % S::NC;
#pragma unroll
  for (int e = 0; e < PF; ++e) {
    const int fc = cc * S::CF + e % S::CF;
    if (fc < NF) s[e] = dot4(cur[e], v4[32 * fc], s[e]);
  }
  if (cc != S::NC - 1) return;
#pragma unroll
  for (int i = 0; i < S::R; ++i) {
    const int u = rg * S::R + i;
    if (u >= NF) break;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < S::CF; ++q) {
      t += s[i * S::CF + q];
      s[i * S::CF + q] = 0.f;
    }
    t = warp_sum(t);
    const int row = lo + threadIdx.x / 32 + 16 * u;
    if (rhs != nullptr) t = rhs[row] - t;
    if (lane < CLUSTER) cluster.map_shared_rank(dst, lane)[row] = t;
    if (out != nullptr && lane == 0) out[row] = t;
  }
}

template <int NF, bool TRI>
__device__ __forceinline__ void rows_phase(const cg::cluster_group& cluster,
                                           const float* __restrict__ m,
                                           const float* rhs, float* out,
                                           const float* v, float* dst,
                                           int lo, float4 (&buf)[2][PF]) {
  using S = Sub<NF>;
  float s[PF] = {};
  for (int rd = 0; rd < S::ROW_ROUNDS; rd += 2) {
    rows_round<NF, TRI>(cluster, m, rhs, out, v, dst, lo, rd, buf[0], buf[1],
                        s);
    if (rd + 1 < S::ROW_ROUNDS)
      rows_round<NF, TRI>(cluster, m, rhs, out, v, dst, lo, rd + 1, buf[1],
                          buf[0], s);
  }
}

template <int NF, bool TRI>
__device__ __forceinline__ void cols_round(const float* __restrict__ m,
                                           const float* v, int lo, int rd,
                                           const float4 (&cur)[PF],
                                           float4 (&nxt)[PF], float4& s) {
  using S = Sub<NF>;
  if (rd + 1 < S::COL_ROUNDS) cols_load<NF, TRI>(m, rd + 1, nxt, lo);
  const int gi = threadIdx.x / S::SEG;
  const int r0 = (TRI ? lo : 0) + gi;
#pragma unroll
  for (int e = 0; e < PF; ++e) {
    const int r = r0 + S::G * (rd * PF + e);
    if (gi < S::G && r < S::KB) {
      const float x = v[r];
      s.x = fmaf(cur[e].x, x, s.x);
      s.y = fmaf(cur[e].y, x, s.y);
      s.z = fmaf(cur[e].z, x, s.z);
      s.w = fmaf(cur[e].w, x, s.w);
    }
  }
}

// M^T v on the CTA's columns; then the G partial sums through part, T
// threads a column each summing every T-th group in order, a shuffle
// tree, and the sum, minus from rhs, into dst of every CTA and into out.
template <int NF, bool TRI>
__device__ __forceinline__ void cols_phase(const cg::cluster_group& cluster,
                                           const float* __restrict__ m,
                                           const float* rhs, float* out,
                                           const float* v, float* dst,
                                           float* part, int lo,
                                           float4 (&buf)[2][PF]) {
  using S = Sub<NF>;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  const int r_lo = TRI ? lo : 0;
  for (int rd = 0; rd < S::COL_ROUNDS && r_lo + S::G * PF * rd < S::KB;
       rd += 2) {
    cols_round<NF, TRI>(m, v, lo, rd, buf[0], buf[1], s);
    if (rd + 1 < S::COL_ROUNDS)
      cols_round<NF, TRI>(m, v, lo, rd + 1, buf[1], buf[0], s);
  }
  const int gi = threadIdx.x / S::SEG, f = threadIdx.x % S::SEG;
  if (gi < S::G) reinterpret_cast<float4*>(part + gi * S::W)[f] = s;
  __syncthreads();
  if (threadIdx.x >= S::T * S::W) return;  // whole warps
  const int c = threadIdx.x / S::T, h = threadIdx.x % S::T;
  float t = 0.f;
#pragma unroll
  for (int q = h; q < S::G; q += S::T) t += part[q * S::W + c];
#pragma unroll
  for (int off = S::T / 2; off > 0; off >>= 1)
    t += __shfl_xor_sync(0xffffffffu, t, off);
  if (rhs != nullptr) t = rhs[lo + c] - t;
#pragma unroll
  for (int k = h; k < CLUSTER; k += S::T)
    cluster.map_shared_rank(dst, k)[lo + c] = t;
  if (out != nullptr && h == 0) out[lo + c] = t;
}

// K2, both sweeps in one launch: one cluster of CLUSTER CTAs a graph
// (blockIdx.y). Each CTA keeps the vector a step reads, every index, in
// shared memory and writes its share of the step's result into every
// CTA's other vector (distributed shared memory); one cluster barrier a
// step, with the next step's first round of loads issued between its
// arrive and its wait. Steps: y_0; t_j = b_j - lp_j y_{j-1}, y_j = ldinv_j
// t_j; x_{nb-1} = ldinv_{nb-1}^T y_{nb-1}; t_j = y_j - lp_{j+1}^T x_{j+1},
// x_j = ldinv_j^T t_j.
template <int NF>
__global__ void __launch_bounds__(SUB_THREADS, 1)
band_substitute(const float* __restrict__ ldinv, const float* __restrict__ lp,
                const float* __restrict__ bp, float* __restrict__ y,
                float* __restrict__ x, int nb) {
  using S = Sub<NF>;
  const cg::cluster_group cluster = cg::this_cluster();
  const size_t gv = blockIdx.y * (size_t)nb * S::KB, gm = gv * S::KB;
  const size_t blk = (size_t)S::KB * S::KB;
  ldinv += gm;
  lp += gm;
  bp += gv;
  y += gv;
  x += gv;
  extern __shared__ __align__(16) float sm[];
  float* vec[2] = {sm, sm + S::KB};
  float* part = sm + 2 * S::KB;  // G x W partial sums
  const int lo = cluster.block_rank() * S::W;
  for (int c = threadIdx.x; c < S::KB; c += SUB_THREADS) vec[0][c] = bp[c];
  float4 buf[2][PF];
  rows_load<NF, true>(ldinv, 0, buf[0], lo);
  cluster_arrive();  // b_0 in place, every CTA running before DSMEM
  cluster_wait();
  int p = 0;  // step: reads vec[p % 2], writes vec[(p + 1) % 2]
  for (int j = 0; j < nb; ++j) {
    if (j > 0) {
      rows_phase<NF, false>(cluster, lp + j * blk, bp + (size_t)j * S::KB,
                            nullptr, vec[p % 2], vec[(p + 1) % 2], lo, buf);
      ++p;
      cluster_arrive();
      rows_load<NF, true>(ldinv + j * blk, 0, buf[0], lo);
      cluster_wait();
    }
    rows_phase<NF, true>(cluster, ldinv + j * blk, nullptr,
                         y + (size_t)j * S::KB, vec[p % 2], vec[(p + 1) % 2],
                         lo, buf);
    ++p;
    cluster_arrive();
    if (j + 1 < nb)
      rows_load<NF, false>(lp + (j + 1) * blk, 0, buf[0], lo);
    else
      cols_load<NF, true>(ldinv + j * blk, 0, buf[0], lo);
    cluster_wait();
  }
  for (int j = nb - 1; j >= 0; --j) {
    if (j < nb - 1) {
      // y_j was written by this CTA (its rows are its columns here)
      cols_phase<NF, false>(cluster, lp + (j + 1) * blk, y + (size_t)j * S::KB,
                            nullptr, vec[p % 2], vec[(p + 1) % 2], part, lo,
                            buf);
      ++p;
      cluster_arrive();
      cols_load<NF, true>(ldinv + j * blk, 0, buf[0], lo);
      cluster_wait();
    }
    cols_phase<NF, true>(cluster, ldinv + j * blk, nullptr,
                         x + (size_t)j * S::KB, vec[p % 2], vec[(p + 1) % 2],
                         part, lo, buf);
    ++p;
    cluster_arrive();
    if (j > 0) cols_load<NF, false>(lp + j * blk, 0, buf[0], lo);
    cluster_wait();
  }
}

template <int NF>
cudaError_t launch_substitute(cudaStream_t s, const float* ldinv,
                              const float* lp, const float* bp, float* y,
                              float* x, int nb, int batch) {
  using S = Sub<NF>;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CLUSTER;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(CLUSTER, batch);
  cfg.blockDim = dim3(SUB_THREADS);
  cfg.dynamicSmemBytes = (2 * S::KB + S::G * S::W) * sizeof(float);
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, band_substitute<NF>, ldinv, lp, bp, y, x,
                            nb);
}

using SubstituteLaunch = cudaError_t (*)(cudaStream_t, const float*,
                                         const float*, const float*, float*,
                                         float*, int, int);
template <int... NF>
constexpr SubstituteLaunch substitute_table(int nf,
                                            std::integer_sequence<int, NF...>) {
  constexpr SubstituteLaunch table[] = {launch_substitute<NF + 1>...};
  return table[nf - 1];
}

template <int BM>
cudaError_t launch_lp_schur(cudaStream_t s, int batch, int kb, int j,
                            const float* dsym_j, const float* lcoup_j,
                            const float* ldinv_prev, float* lp, float* lp_j,
                            float* a, size_t gs, size_t ws, unsigned* sync,
                            size_t nsync) {
  const int nt = kb / BM;
  constexpr size_t smem = gemm_smem<BM>();
  auto lp_gemm = gemm_nt<BM, false, true, false>;
  auto schur_gemm = gemm_nt<BM, true, false, true>;
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      lp_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      schur_gemm, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  if (j > 0) {
    // lp_j = Lcoup_j ldinv_{j-1}^T
    lp_gemm<<<dim3(nt * nt, batch), GEMM_THREADS, smem, s>>>(
        kb, kb, lcoup_j, gs, ldinv_prev, gs, nullptr, 0, lp_j, gs, nullptr, 0,
        nullptr, 0);
    RETURN_IF_ERROR(cudaGetLastError());
  }
  // D̂_j = Dsym_j - lp_j lp_j^T into the running block; at j = 0 the copy,
  // which also zeroes lp_0 and the work lists' tickets and flags
  schur_gemm<<<dim3(nt * (nt + 1) / 2, batch), GEMM_THREADS, smem, s>>>(
      kb, j > 0 ? kb : 0, lp_j, gs, lp_j, gs, dsym_j, gs, a, ws,
      j > 0 ? nullptr : lp, gs, j > 0 ? nullptr : sync, nsync);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. dsym, lcoup: (batch, nb, kb, kb) f32 inputs (dsym symmetric). ldinv,
// lp: (batch, nb, kb, kb) outputs, every element written, lp[:, 0] = 0.
// work: work_floats floats, at least batch x 2 kb^2 (the running block,
// then L's sub-diagonal panels, a graph) + nb kb / PANEL (a ticket for
// each trail_offdiag launch) + batch (kb - PANEL) / 32 (a flag for each
// strip); the call clears the tickets and flags itself. items, if not
// null, gets the strips, update tiles and off-diagonal tiles of the
// trail_offdiag launches added to its first three counts, and the rows of
// the call's strips (UT) in its fourth.
int band_factorize_f32(int device, const float* dsym, const float* lcoup,
                       float* ldinv, float* lp, float* work,
                       long long work_floats, int nb, int kb, int batch,
                       long long* items, void* stream) {
  if (nb < 1 || kb < PANEL || kb % PANEL != 0 || batch < 1 ||
      batch > MAX_BATCH)
    return cudaErrorInvalidValue;
  const size_t blk = (size_t)kb * kb;
  const size_t gs = nb * blk;   // graph stride of the band
  const size_t ws = 2 * blk;    // graph stride of work
  const int np = kb / PANEL;
  int sms = 0;
  RETURN_IF_ERROR(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         device));
  const int ut = trail_rows(kb, batch, (long long)TRAIL_CTAS * sms);
  const int sf = (kb - PANEL) / MIN_UT;  // flags a graph: strips at most
  const size_t nsync = (size_t)nb * np + (size_t)batch * sf;
  if (work_floats < 0 || (size_t)work_floats < batch * ws + nsync)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* a = work;              // running block D̂_j, factored in place
  float* lbuf = work + blk;     // L_j's panels below the diagonal panels
  unsigned* tickets = reinterpret_cast<unsigned*>(work + batch * ws);
  unsigned* flags = tickets + (size_t)nb * np;
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      panel_chol_inv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PANEL_SMEM));
  const auto trail = ut == 64 ? trail_offdiag<64> : trail_offdiag<32>;
  const size_t trail_bytes = ut == 64 ? trail_smem<64>() : trail_smem<32>();
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      trail, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)trail_bytes));
  if (items != nullptr) items[3] = ut;
  for (int j = 0; j < nb; ++j) {
    float* li = ldinv + j * blk;
    const float* prev = j > 0 ? ldinv + (j - 1) * blk : nullptr;
    // 128x128 tiles where they alone give >= 32 CTAs a graph
    RETURN_IF_ERROR(kb >= 1024
        ? launch_lp_schur<128>(s, batch, kb, j, dsym + j * blk,
                               lcoup + j * blk, prev, lp, lp + j * blk, a, gs,
                               ws, tickets, nsync)
        : launch_lp_schur<64>(s, batch, kb, j, dsym + j * blk,
                              lcoup + j * blk, prev, lp, lp + j * blk, a, gs,
                              ws, tickets, nsync));
    for (int i = 0; i < np; ++i) {
      const int o = i * PANEL;
      panel_chol_inv<<<batch, PANEL_THREADS, PANEL_SMEM, s>>>(
          kb, a + (size_t)o * kb + o, ws, li + (size_t)o * kb + o, gs);
      RETURN_IF_ERROR(cudaGetLastError());
      const int n_strip = (kb - o - PANEL) / ut, n_off = o / OT;
      const long long n_upd = (long long)n_strip * (n_strip + 1) / 2;
      if (items != nullptr) {
        items[0] += (long long)batch * n_strip;
        items[1] += batch * n_upd;
        items[2] += (long long)batch * n_off;
      }
      const long long n_items = batch * (n_strip + n_upd + n_off);
      if (n_items == 0) continue;
      trail<<<(unsigned)n_items, 256, trail_bytes, s>>>(
          kb, o, n_strip, n_off, batch, a, ws, li, gs, lbuf, ws,
          tickets + j * np + i, flags, sf, (unsigned)(j * np + i + 1));
      RETURN_IF_ERROR(cudaGetLastError());
    }
  }
  return cudaGetLastError();
}

// K2. ldinv, lp: (batch, nb, kb, kb) f32; bp: (batch, nb, kb). y: (batch,
// nb, kb) scratch for the forward sweep; x: (batch, nb, kb) output.
int band_substitute_f32(int device, const float* ldinv, const float* lp,
                        const float* bp, float* y, float* x, int nb, int kb,
                        int batch, void* stream) {
  if (nb < 1 || kb < PANEL || kb % PANEL != 0 || batch < 1 ||
      batch > MAX_BATCH)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(device));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // one kernel for each kb = 128 NF, NF = 1 .. MAX_NF
  if (kb > MAX_NF * PANEL) return cudaErrorInvalidValue;
  return substitute_table(kb / PANEL, std::make_integer_sequence<int, MAX_NF>())(
      s, ldinv, lp, bp, y, x, nb, batch);
}

}  // extern "C"
