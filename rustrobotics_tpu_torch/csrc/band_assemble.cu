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
// gone. The job plan here is the band layout's sorted-scatter plan: each
// unique destination dest[u] is one segment src[seg_ptr[u] .. seg_ptr[u+1])
// of triplet indices, in a fixed order.
//
// What bounds it on an H100: bytes. The band is written once (B nb kb 2kb
// floats, 23.1 MB a graph at corridor-1728's kb = 512, nb = 11) and the
// kept values are read once (0.2 MB a graph); no arithmetic to speak of.
// The design: the C entry zeroes the band with cudaMemsetAsync on the
// caller's stream, then one thread per (unique destination, graph) sums
// its segment in plan order and stores the sum once. No atomics, so the
// band is the same bit for bit in every run (the plain index_add_ on the
// card is atomic and is not). Neighbouring threads take neighbouring
// destinations of one graph, so the stores of a warp fall on a few lines.
// The reads are gathers from vals (B, nnz) row-major; a layout with the
// batch minor would coalesce them, later.
//
// Offsets are 64-bit throughout: B nb kb 2kb is 46.1 M floats at B = 8 and
// passes 2^31 beyond B ~ 370 at that shape.
//
// The entry point has a plain C interface for ctypes, takes the device of
// its tensors and returns the cudaError_t of its calls (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
band_assemble(const float* __restrict__ vals, int64_t nnz,
              const int64_t* __restrict__ src,
              const int64_t* __restrict__ seg_ptr,
              const int64_t* __restrict__ dest, int64_t nuniq,
              float* __restrict__ out, int64_t band, int64_t jobs) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= jobs) return;
  const int64_t g = t / nuniq, u = t - g * nuniq;
  const float* v = vals + g * nnz;
  float s = 0.f;
  for (int64_t k = seg_ptr[u]; k < seg_ptr[u + 1]; ++k) s += v[src[k]];
  out[g * band + dest[u]] = s;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vals: (batch, nnz) f32. src: (kept,) triplet indices in plan order;
// seg_ptr: (nuniq + 1,) segment starts in src; dest: (nuniq,) flat band
// offsets, all int64. out: (batch, band) f32, band = nb kb 2kb, written
// whole (zeros off the plan's destinations).
int band_assemble_f32(int device, const float* vals, int64_t nnz,
                      const int64_t* src, const int64_t* seg_ptr,
                      const int64_t* dest, int64_t nuniq, float* out,
                      int64_t band, int batch, void* stream) {
  if (batch < 1 || nnz < 0 || nuniq < 0 || band < 1)
    return cudaErrorInvalidValue;
  const int64_t jobs = nuniq * batch;
  const int64_t blocks = (jobs + THREADS - 1) / THREADS;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, (size_t)batch * band * sizeof(float), s);
  if (err != cudaSuccess) return err;
  if (blocks > 0) {
    band_assemble<<<(unsigned)blocks, THREADS, 0, s>>>(
        vals, nnz, src, seg_ptr, dest, nuniq, out, band, jobs);
  }
  return cudaGetLastError();
}

}  // extern "C"
