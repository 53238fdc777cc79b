// Banded inverse-Cholesky factorization (K1) and substitution (K2) for
// Hopper (sm_90a), IEEE f32 with FMA on the CUDA cores.
//
// K1 replaces rustrobotics_tpu/ops/band_chol_pallas.py::factorize_pallas
// (kernel _factor_kernel, helpers _blocked_chol_inv, _panel_chol_inv,
// _chol_inv_small). Sequential over block rows j of the RCM-banded system:
//     lp_j    = Lcoup_j ldinv_{j-1}^T        (lp_0 = 0)
//     D̂_j     = Dsym_j - lp_j lp_j^T
//     ldinv_j = chol(D̂_j)^-1
// What bounds it on an H100: the function needs ~2.7 kb^3 FLOP per block
// row (chol and triangular inverse kb^3/3 each, the product against the
// triangle ldinv_{j-1} and the symmetric Schur update kb^3 each: 3.7e9 at
// kb=512, nb=11, 0.055 ms at the 67 TFLOP/s f32 peak) but it is a
// chain: block row j needs ldinv_{j-1}, and inside a row the 128-wide
// panels follow one another, each a 128-step scalar pivot recursion. The
// running (kb, kb) block is 1 MiB at kb=512, far above one CTA's 227 KB of
// shared memory, so unlike the TPU kernel (block resident in VMEM) it lives
// in global memory, where the 50 MB L2 keeps it. The design: the host loop
// below issues, per block row, a tiled f32 GEMM kernel (64x64 tiles) for
// every product (coupling panel, Schur update, panel solves, trailing
// updates, off-diagonal inverse panels) and one single-CTA kernel per
// 128x128 diagonal panel that runs the pivot recursion in shared memory
// and emits L^-1 of the panel. About 20 launches per block row, all on the
// caller's stream; the latency of that chain, not the FLOP rate, is what
// this first version pays.
//
// A fleet of B same-structure graphs runs as B chains side by side: every
// kernel of the host loop takes a grid axis over the graphs (blockIdx.z of
// the GEMM, blockIdx.x of the panel and sweep kernels) and per-graph
// strides, so the loop issues the same ~250 launches for all B graphs.
// The per-graph arithmetic is that of B = 1, bit for bit.
//
// K2 replaces ...::substitute_pallas (kernels _fwd_kernel, _bwd_kernel):
//     y_j = ldinv_j (b_j - lp_j y_{j-1}),      j = 0 .. nb-1
//     x_j = ldinv_j^T (y_j - lp_{j+1}^T x_{j+1}), j = nb-1 .. 0
// What bounds it: two chains of nb dependent (kb, kb) GEMVs; the bytes
// (ldinv's lower triangles and lp_1.., ~1.5 nb kb^2 f32, 16 MB at kb=512,
// nb=11, ~5 us at 3.35 TB/s) bound it, the FLOPs do not. The design: one CTA per sweep loops over j
// (the counterpart of the sequential grid), keeps the carry y_{j-1} or
// x_{j+1} in shared memory and streams each row of the matrices with
// coalesced loads. One SM cannot pull HBM at the card's rate, so this
// first version runs far above its bound.
//
// Entry points have a plain C interface for ctypes. Each takes the
// device of its tensors (this library's runtime keeps its own current
// device, apart from PyTorch's) and returns the cudaError_t of its
// launches (0 on success).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int PANEL = 128;          // diagonal panel of the pivot kernel
constexpr int TILE = 64;            // GEMM output tile
constexpr int TK = 16;              // GEMM depth step
constexpr int GEMM_THREADS = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int PANEL_THREADS = 512;
constexpr int SUB_THREADS = 1024;   // multiple of PANEL and of 32
constexpr size_t PANEL_SMEM = (2 * PANEL * PANEL + PANEL) * sizeof(float);
constexpr int MAX_BATCH = 65535;    // the GEMM's grid z limit

// C[M, N] = alpha * A[M, K] op(B) + beta * C, row-major with leading
// dimensions; op(B) = B^T with B stored (N, K) when TRANS_B, else B stored
// (K, N). M and N are multiples of TILE, K of TK. C must not overlap A or
// B. With beta == 0, C is not read. Graph blockIdx.z reads and writes at
// blockIdx.z times the strides sa, sb, sc.
template <bool TRANS_B>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_f32(int K, float alpha, const float* __restrict__ A, int lda, size_t sa,
         const float* __restrict__ B, int ldb, size_t sb, float beta,
         float* __restrict__ C, int ldc, size_t sc) {
  A += blockIdx.z * sa;
  B += blockIdx.z * sb;
  C += blockIdx.z * sc;
  __shared__ float As[TK][TILE + 1];
  __shared__ float Bs[TK][TILE + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int l = tid; l < TILE * TK; l += GEMM_THREADS) {
      const int r = l / TK, kk = l % TK;
      As[kk][r] = A[(size_t)(m0 + r) * lda + k0 + kk];
      if constexpr (TRANS_B) {
        Bs[kk][r] = B[(size_t)(n0 + r) * ldb + k0 + kk];
      } else {
        const int kr = l / TILE, c = l % TILE;
        Bs[kr][c] = B[(size_t)(k0 + kr) * ldb + n0 + c];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* c = C + (size_t)(m0 + ty + 16 * i) * ldc + n0 + tx + 16 * j;
      const float v = alpha * acc[i][j];
      *c = (beta == 0.f) ? v : fmaf(beta, *c, v);
    }
}

// One CTA: the (PANEL, PANEL) SPD block at a_g (lower triangle read and
// mirrored) -> its inverse Cholesky factor, lower triangular with zeros
// above the diagonal, at linv_g. Right-looking: pivot step j takes column
// j of L (from row j: the trailing block is kept symmetric, and a row is a
// conflict-free read), scales row j of X, then applies the rank-1 update
// to the trailing block and eliminates column j from the rows of X below,
// so X = L^-1 is built as [L | I] is reduced. Two barriers a step. CTA
// blockIdx.x takes graph blockIdx.x, at strides sa and sl.
__global__ void __launch_bounds__(PANEL_THREADS)
panel_chol_inv(const float* __restrict__ a_g, int lda, size_t sa,
               float* __restrict__ linv_g, int ldl, size_t sl) {
  a_g += blockIdx.x * sa;
  linv_g += blockIdx.x * sl;
  extern __shared__ float smem[];
  float* a = smem;                    // trailing block, PANEL x PANEL
  float* x = smem + PANEL * PANEL;    // L^-1 under construction
  float* lcol = x + PANEL * PANEL;    // column j of L (0 above j)
  const int tid = threadIdx.x;
  for (int l = tid; l < PANEL * PANEL; l += PANEL_THREADS) {
    const int r = l / PANEL, c = l % PANEL;
    a[l] = (c <= r) ? a_g[(size_t)r * lda + c] : a_g[(size_t)c * lda + r];
    x[l] = (r == c) ? 1.f : 0.f;
  }
  __syncthreads();
  for (int j = 0; j < PANEL; ++j) {
    const float piv = sqrtf(a[j * PANEL + j]);
    if (tid < PANEL) {
      lcol[tid] = (tid >= j) ? a[j * PANEL + tid] / piv : 0.f;
      if (tid <= j) x[j * PANEL + tid] /= piv;
    }
    __syncthreads();
    const int rows = PANEL - 1 - j;
    for (int l = tid; l < rows * PANEL; l += PANEL_THREADS) {
      const int r = j + 1 + l / PANEL, c = l % PANEL;
      if (c > j) {
        a[r * PANEL + c] = fmaf(-lcol[r], lcol[c], a[r * PANEL + c]);
      } else {
        x[r * PANEL + c] = fmaf(-lcol[r], x[j * PANEL + c], x[r * PANEL + c]);
      }
    }
    __syncthreads();
  }
  for (int l = tid; l < PANEL * PANEL; l += PANEL_THREADS) {
    linv_g[(size_t)(l / PANEL) * ldl + l % PANEL] = x[l];
  }
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// res[r] = sum_c m[r, c] v[c], r < kb: a warp per row, lanes along the row
// (coalesced). Ends with a barrier.
__device__ void gemv(const float* __restrict__ m, const float* v, float* res,
                     int kb) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarp = blockDim.x >> 5;
  for (int r = warp; r < kb; r += nwarp) {
    const float* row = m + (size_t)r * kb;
    float s = 0.f;
    for (int c = lane; c < kb; c += 32) s = fmaf(row[c], v[c], s);
    s = warp_sum(s);
    if (lane == 0) res[r] = s;
  }
  __syncthreads();
}

// res[c] = sum_r m[r, c] v[r], c < kb: columns in chunks of PANEL, the rows
// split over blockDim / PANEL groups (a warp reads 32 consecutive floats of
// one row), partial sums reduced through `part`. Ends with a barrier.
__device__ void gemv_t(const float* __restrict__ m, const float* v, float* part,
                       float* res, int kb) {
  const int groups = blockDim.x / PANEL;
  const int g = threadIdx.x / PANEL, cl = threadIdx.x % PANEL;
  for (int c0 = 0; c0 < kb; c0 += PANEL) {
    float s = 0.f;
    for (int r = g; r < kb; r += groups)
      s = fmaf(m[(size_t)r * kb + c0 + cl], v[r], s);
    part[g * PANEL + cl] = s;
    __syncthreads();
    if (g == 0) {
      float t = 0.f;
      for (int q = 0; q < groups; ++q) t += part[q * PANEL + cl];
      res[c0 + cl] = t;
    }
    __syncthreads();
  }
}

// Forward sweep, one CTA a graph: y_j = ldinv_j (b_j - lp_j y_{j-1}).
__global__ void __launch_bounds__(SUB_THREADS)
band_forward(const float* __restrict__ ldinv, const float* __restrict__ lp,
             const float* __restrict__ bp, float* __restrict__ y, int nb, int kb) {
  const size_t gv = blockIdx.x * (size_t)nb * kb, gm = gv * kb;
  ldinv += gm;
  lp += gm;
  bp += gv;
  y += gv;
  extern __shared__ float sm[];
  float* carry = sm;       // y_{j-1}, then y_j
  float* t = sm + kb;      // right-hand side of step j
  for (int j = 0; j < nb; ++j) {
    const size_t o = (size_t)j * kb * kb;
    if (j > 0) gemv(lp + o, carry, t, kb);
    for (int r = threadIdx.x; r < kb; r += blockDim.x)
      t[r] = (j > 0) ? bp[(size_t)j * kb + r] - t[r] : bp[r];
    __syncthreads();
    gemv(ldinv + o, t, carry, kb);
    for (int r = threadIdx.x; r < kb; r += blockDim.x)
      y[(size_t)j * kb + r] = carry[r];
  }
}

// Backward sweep, one CTA a graph: x_j = ldinv_j^T (y_j - lp_{j+1}^T
// x_{j+1}); the lp term is skipped at the last block (lp[nb] is never read).
__global__ void __launch_bounds__(SUB_THREADS)
band_backward(const float* __restrict__ ldinv, const float* __restrict__ lp,
              const float* __restrict__ y, float* __restrict__ x, int nb, int kb) {
  const size_t gv = blockIdx.x * (size_t)nb * kb, gm = gv * kb;
  ldinv += gm;
  lp += gm;
  y += gv;
  x += gv;
  extern __shared__ float sm[];
  float* carry = sm;           // x_{j+1}, then x_j
  float* t = sm + kb;
  float* part = sm + 2 * kb;   // SUB_THREADS partial sums
  for (int j = nb - 1; j >= 0; --j) {
    const bool last = (j == nb - 1);
    if (!last) gemv_t(lp + (size_t)(j + 1) * kb * kb, carry, part, t, kb);
    for (int r = threadIdx.x; r < kb; r += blockDim.x)
      t[r] = last ? y[(size_t)j * kb + r] : y[(size_t)j * kb + r] - t[r];
    __syncthreads();
    gemv_t(ldinv + (size_t)j * kb * kb, t, part, carry, kb);
    for (int r = threadIdx.x; r < kb; r += blockDim.x)
      x[(size_t)j * kb + r] = carry[r];
  }
}

// One GEMM per graph of the batch, each operand at its own graph stride.
struct Batch {
  cudaStream_t s;
  int count;
};

template <bool TRANS_B>
cudaError_t gemm(Batch bt, int M, int N, int K, float alpha, const float* A,
                 int lda, size_t sa, const float* B, int ldb, size_t sb,
                 float beta, float* C, int ldc, size_t sc) {
  const dim3 grid(N / TILE, M / TILE, bt.count);
  gemm_f32<TRANS_B><<<grid, GEMM_THREADS, 0, bt.s>>>(K, alpha, A, lda, sa, B,
                                                      ldb, sb, beta, C, ldc, sc);
  return cudaGetLastError();
}

}  // namespace

#define RETURN_IF_ERROR(expr)             \
  do {                                    \
    const cudaError_t err_ = (expr);      \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1. dsym, lcoup: (batch, nb, kb, kb) f32 inputs (dsym symmetric). ldinv,
// lp: (batch, nb, kb, kb) outputs, lp[:, 0] = 0. work: batch x (2 kb^2 +
// PANEL kb) floats.
int band_factorize_f32(int device, const float* dsym, const float* lcoup,
                       float* ldinv, float* lp, float* work, int nb, int kb,
                       int batch, void* stream) {
  if (nb < 1 || kb < PANEL || kb % PANEL != 0 || batch < 1 ||
      batch > MAX_BATCH)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(device));
  const Batch bt{static_cast<cudaStream_t>(stream), batch};
  const cudaStream_t s = bt.s;
  const size_t blk = (size_t)kb * kb;
  const size_t gs = nb * blk;                  // graph stride of the band
  const size_t ws = 2 * blk + (size_t)PANEL * kb;  // graph stride of work
  float* a = work;               // running block D̂_j, factored in place
  float* lbuf = work + blk;      // L_j's panels below the diagonal panels
  float* acc = work + 2 * blk;   // PANEL x kb scratch (leading dim kb)
  const int np = kb / PANEL;
  const size_t row = blk * sizeof(float);
  RETURN_IF_ERROR(cudaFuncSetAttribute(
      panel_chol_inv, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PANEL_SMEM));
  // block j of every graph: one strided memset or copy for the batch
  RETURN_IF_ERROR(cudaMemset2DAsync(lp, gs * sizeof(float), 0, row, batch, s));
  for (int j = 0; j < nb; ++j) {
    float* li = ldinv + j * blk;
    RETURN_IF_ERROR(
        cudaMemset2DAsync(li, gs * sizeof(float), 0, row, batch, s));
    RETURN_IF_ERROR(cudaMemcpy2DAsync(a, ws * sizeof(float), dsym + j * blk,
                                      gs * sizeof(float), row, batch,
                                      cudaMemcpyDeviceToDevice, s));
    if (j > 0) {
      float* lpj = lp + j * blk;
      // lp_j = Lcoup_j ldinv_{j-1}^T ; D̂_j = Dsym_j - lp_j lp_j^T
      RETURN_IF_ERROR(gemm<true>(bt, kb, kb, kb, 1.f, lcoup + j * blk, kb, gs,
                                 ldinv + (j - 1) * blk, kb, gs, 0.f, lpj, kb,
                                 gs));
      RETURN_IF_ERROR(gemm<true>(bt, kb, kb, kb, -1.f, lpj, kb, gs, lpj, kb,
                                 gs, 1.f, a, kb, ws));
    }
    // diagonal panels: Linv_ii, then L[rest, i] = A[rest, i] Linv_ii^T and
    // the trailing update A[rest, rest] -= L[rest, i] L[rest, i]^T
    for (int i = 0; i < np; ++i) {
      const size_t o = (size_t)i * PANEL;
      panel_chol_inv<<<batch, PANEL_THREADS, PANEL_SMEM, s>>>(
          a + o * kb + o, kb, ws, li + o * kb + o, kb, gs);
      RETURN_IF_ERROR(cudaGetLastError());
      const int rest = kb - (i + 1) * PANEL;
      if (rest == 0) continue;
      const size_t r0 = o + PANEL;
      RETURN_IF_ERROR(gemm<true>(bt, rest, PANEL, PANEL, 1.f, a + r0 * kb + o,
                                 kb, ws, li + o * kb + o, kb, gs, 0.f,
                                 lbuf + r0 * kb + o, kb, ws));
      RETURN_IF_ERROR(gemm<true>(bt, rest, rest, PANEL, -1.f,
                                 lbuf + r0 * kb + o, kb, ws,
                                 lbuf + r0 * kb + o, kb, ws, 1.f,
                                 a + r0 * kb + r0, kb, ws));
    }
    // off-diagonal inverse panels, one panel row k at a time:
    // Linv[k, :k] = -Linv_kk (L[k, :k] Linv[:k, :k]); Linv's upper panels
    // are still zero, so the product over the full :k range is the sum
    // over m = i .. k-1 of the block forward substitution.
    for (int k = 1; k < np; ++k) {
      const size_t r0 = (size_t)k * PANEL;
      const int w = k * PANEL;
      RETURN_IF_ERROR(gemm<false>(bt, PANEL, w, w, 1.f, lbuf + r0 * kb, kb,
                                  ws, li, kb, gs, 0.f, acc, kb, ws));
      RETURN_IF_ERROR(gemm<false>(bt, PANEL, w, PANEL, -1.f,
                                  li + r0 * kb + r0, kb, gs, acc, kb, ws, 0.f,
                                  li + r0 * kb, kb, gs));
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
  const size_t smem = (2 * (size_t)kb + SUB_THREADS) * sizeof(float);
  band_forward<<<batch, SUB_THREADS, smem, s>>>(ldinv, lp, bp, y, nb, kb);
  RETURN_IF_ERROR(cudaGetLastError());
  band_backward<<<batch, SUB_THREADS, smem, s>>>(ldinv, lp, y, x, nb, kb);
  return cudaGetLastError();
}

}  // extern "C"
