// Block-banded SpMV (K3) for Hopper (sm_90a), IEEE f32 with FMA on the
// CUDA cores.
//
// K3 replaces rustrobotics_tpu/ops/banded.py::banded_matvec_pallas (its
// inner kernel): with hb the RCM-banded normal equations stored as
// (nb, kb, 128, 128) tiles, kb = 2*half + 1 block diagonals, and xp the
// band-space x as (nb + kb - 1, 128) zero-padded blocks,
//     y[I*128 + i] = sum_d sum_j hb[I, d, i, j] * xp[I + d, j].
// What bounds it on an H100: the bytes. A call reads all of hb once
// (nb*kb*64 KB: 24.2 MB at corridor-1728's nb = 41, kb = 9, ~7.2 us at
// 3.35 TB/s) and does two FLOP per element read (12.1 MFLOP, ~0.2 us at
// the 67 TFLOP/s f32 peak). The design: a (128/ROWS, nb) grid, a warp per
// output row, so a block row's 128 rows spread over 16 CTAs and the grid
// fills all 132 SMs (one CTA per block row would fill 41). Each CTA copies
// its block row's (kb*128) window of x into shared memory once; each
// lane then reads 16 bytes of every tile row hb[I, d, i, :], so a warp's
// load of one tile row is one coalesced 512-byte line. The TPU kernel's
// padding of nb to a multiple of 8 (its (8, 128) output tile) has no
// counterpart here.
//
// A fleet of B graphs (one band plan, B sets of values) is a third grid
// axis: blockIdx.z picks the graph, whose hb, xp and y sit at fixed strides
// (nb*kb*128*128, (nb+kb-1)*128 and nb*128 floats). Each warp's summation
// order does not depend on B, so graph i of a batched call equals a
// one-graph call on graph i bit for bit. The bound grows with B: the fleet
// of 8 reads 8 x 24.23 MB (~57.9 us at 3.35 TB/s).
//
// The entry point has a plain C interface for ctypes. It takes the device
// of its tensors (this library's runtime keeps its own current device,
// apart from PyTorch's) and returns the cudaError_t of its launch (0 on
// success).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int LANE = 128;            // tile edge
constexpr int ROWS = 8;              // output rows per CTA, a warp each
constexpr int THREADS = ROWS * 32;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 232448;  // 227 KB: one CTA's limit on Hopper

__global__ void __launch_bounds__(THREADS)
banded_matvec(const float* __restrict__ hb, const float* __restrict__ xp,
              float* __restrict__ y, int kb) {
  extern __shared__ float4 xs[];  // kb * LANE / 4
  const int blk = blockIdx.y;
  const int nb = gridDim.y;
  const size_t graph = blockIdx.z;
  hb += graph * nb * kb * LANE * LANE;
  xp += graph * (nb + kb - 1) * LANE;
  y += graph * nb * LANE;
  const float4* xw = reinterpret_cast<const float4*>(xp + (size_t)blk * LANE);
  for (int l = threadIdx.x; l < kb * LANE / 4; l += THREADS) xs[l] = xw[l];
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS + warp;
  // hb[blk, d, row, :] starts at ((blk * kb + d) * LANE + row) * LANE
  const float4* h = reinterpret_cast<const float4*>(
      hb + ((size_t)blk * kb * LANE + row) * LANE) + lane;
  const size_t tile4 = LANE * LANE / 4;  // float4s between diagonals
  float acc = 0.f;
#pragma unroll 8
  for (int d = 0; d < kb; ++d) {
    const float4 a = __ldg(h + d * tile4);
    const float4 b = xs[d * (LANE / 4) + lane];
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[(size_t)blk * LANE + row] = acc;
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

// K3 over `batch` graphs. hb: (batch, nb, kb, 128, 128) f32; xp: (batch,
// nb + kb - 1, 128) f32; y: (batch, nb*128) output. kb is odd; hb and xp
// are 16-byte aligned.
int banded_matvec_f32(int device, const float* hb, const float* xp, float* y,
                      int nb, int kb, int batch, void* stream) {
  const size_t smem = (size_t)kb * LANE * sizeof(float);
  if (nb < 1 || nb > 65535 || kb < 1 || kb % 2 == 0 || smem > MAX_SMEM ||
      batch < 1 || batch > 65535)
    return cudaErrorInvalidValue;
  RETURN_IF_ERROR(cudaSetDevice(device));
  if (smem > DEFAULT_SMEM)
    RETURN_IF_ERROR(cudaFuncSetAttribute(
        banded_matvec, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem));
  const dim3 grid(LANE / ROWS, nb, batch);
  banded_matvec<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      hb, xp, y, kb);
  return cudaGetLastError();
}

}  // extern "C"
