// Band assembly (K4 at B = 1, K5 for a fleet of B graphs) for Hopper
// (sm_90a), IEEE f32.
//
// K4 replaces tools/tpu_pallas_scatter_probe.py::make_kernel and K5
// tools/tpu_pallas_fleet_scatter_probe.py::make_kernel: the kept (lower
// triangle) triplet values of each graph's normal equations summed into
// its RCM-banded block rows, out[g] = (nb, kb, 2kb) flat, unscaled, zero
// where no triplet lands. The TPU kernels took (3, 3) patches from a
// pre-sorted job stream into (8, 128)-tiled windows, the fleet with the
// batch on the sublanes; those layouts were Mosaic's constraints and are
// gone. What carries over is that each TPU grid step owned an output
// window, zeroed it on chip, accumulated into it and wrote it once.
//
// What bounds it on an H100: bytes. The band is written once (B nb kb 2kb
// floats, 23.1 MB a graph at corridor-1728's kb = 512, nb = 11) and the
// kept values are read once (0.2 MB a graph); no arithmetic to speak of.
//
// The design: one launch, one CTA for each (tile, graph). A tile is TILE
// consecutive band floats (32 KB; eight rows at kb = 512). The plan's
// unique destinations dest[] are sorted, so tile t's are the contiguous
// range dest[tile_ptr[t] .. tile_ptr[t+1]), and destination u sums the
// segment src[seg_ptr[u] .. seg_ptr[u+1]) of triplet indices. The CTA
// zeroes its tile in shared memory; a thread per destination sums its
// segment from 0 in plan order (the order of the plain index_add_ on the
// CPU, so the band is the same bit for bit) and writes the sum into the
// tile (the destinations are distinct: no atomics); then one thread hands
// the whole tile to the TMA as one bulk copy to global memory. A tile with
// no destination (the padded rows at the band's end) stores zeros straight
// from registers. So every band float is written once, with no memset. The
// stores take the default (write-back) cache policy: in the solve
// _prepare_blocks reads the band next, and one graph's band fits in the
// 50 MB L2.
//
// What is left above the bytes is latency: before its first store a CTA
// waits on a chain of four dependent loads (tile_ptr, then seg_ptr and
// dest, then src, then vals). The first destination's seg_ptr and dest
// loads go out before the tile is zeroed, and a segment's src and vals
// loads go out UNROLL at a time before any of them is summed.
//
// Offsets are 64-bit: B nb kb 2kb is 46.1 M floats at B = 8 and passes
// 2^31 beyond B ~ 370 at that shape.
//
// The entry point has a plain C interface for ctypes, takes the device of
// its tensors and returns the cudaError_t of its calls (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
// Band floats a tile: ops/band_chol.py's ASSEMBLE_TILE, which plans the
// tiles. 32 KB of static shared memory, so six CTAs fit on an SM and
// corridor-1728's 704 tiles run in one wave.
constexpr int TILE = 8192;
constexpr int TILE4 = TILE / 4;
// Segment loads in flight at once (corridor-1728: segments of 1.70 on
// average, 15 at most).
constexpr int UNROLL = 8;

// vals[src[k]] summed over k in [k, end), from 0, in order.
__device__ __forceinline__ float segment_sum(const float* __restrict__ v,
                                             const int64_t* __restrict__ src,
                                             int64_t k, int64_t end) {
  float s = 0.f;
  for (; k < end; k += UNROLL) {
    float x[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) x[j] = k + j < end ? v[src[k + j]] : 0.f;
#pragma unroll
    for (int j = 0; j < UNROLL; ++j)
      if (k + j < end) s += x[j];
  }
  return s;
}

__global__ void __launch_bounds__(THREADS)
band_assemble_tiles(const float* __restrict__ vals, int64_t nnz,
                    const int64_t* __restrict__ src,
                    const int64_t* __restrict__ seg_ptr,
                    const int64_t* __restrict__ dest,
                    const int64_t* __restrict__ tile_ptr,
                    float* __restrict__ out, int64_t band) {
  __shared__ __align__(128) float tile[TILE];
  float4* tile4 = reinterpret_cast<float4*>(tile);
  const int64_t t = blockIdx.x, g = blockIdx.y, base = t * TILE;
  const int64_t lo = tile_ptr[t], hi = tile_ptr[t + 1];
  float* o = out + g * band + base;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (lo == hi) {  // the same for every thread of the CTA
    for (int i = threadIdx.x; i < TILE4; i += THREADS)
      reinterpret_cast<float4*>(o)[i] = zero;
    return;
  }
  const float* v = vals + g * nnz;
  const int64_t u0 = lo + threadIdx.x;
  int64_t k0 = 0, end0 = 0, d0 = 0;
  if (u0 < hi) {
    k0 = seg_ptr[u0];
    end0 = seg_ptr[u0 + 1];
    d0 = dest[u0];
  }
  for (int i = threadIdx.x; i < TILE4; i += THREADS) tile4[i] = zero;
  __syncthreads();
  if (u0 < hi) tile[d0 - base] = segment_sum(v, src, k0, end0);
  for (int64_t u = u0 + THREADS; u < hi; u += THREADS)
    tile[dest[u] - base] = segment_sum(v, src, seg_ptr[u], seg_ptr[u + 1]);
  // the tile's shared-memory writes, visible to the TMA (async proxy)
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  if (threadIdx.x == 0) {
    const uint32_t from =
        static_cast<uint32_t>(__cvta_generic_to_shared(tile));
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(o),
        "r"(from), "r"(TILE * 4)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // the tile must stay in shared memory until the copy has read it
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vals: (batch, nnz) f32. src: (kept,) triplet indices in plan order;
// seg_ptr: (nuniq + 1,) segment starts in src; dest: (nuniq,) sorted flat
// band offsets; tile_ptr: (tiles + 1,) tile starts in dest, all int64.
// out: (batch, band) f32, band = nb kb 2kb = tiles TILE, written whole
// (zeros off the plan's destinations) by one kernel launch.
int band_assemble_f32(int device, const float* vals, int64_t nnz,
                      const int64_t* src, const int64_t* seg_ptr,
                      const int64_t* dest, const int64_t* tile_ptr,
                      int64_t tiles, float* out, int64_t band, int batch,
                      void* stream) {
  if (batch < 1 || batch > 65535 || nnz < 0 || tiles < 1 ||
      tiles > INT32_MAX || band != tiles * TILE)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  band_assemble_tiles<<<dim3((unsigned)tiles, (unsigned)batch), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      vals, nnz, src, seg_ptr, dest, tile_ptr, out, band);
  return cudaGetLastError();
}

}  // extern "C"
