// Kernel B: per-candidate histogram of (z, x) id pairs, with row sums.
//
// Replaces the Pallas kernel `_histogram_kernel` of
// src/repro/kernels/histogram.py:44 (pallas_call at :108), launched by
// `histogram_pallas` and `histogram_with_rowsums_pallas`.
//
//   counts[z, x] += #{s : (z_s, x_s) = (z, x)}
//   rows[z]      += #{s : z_s = z}          (only when rows != nullptr)
//
// Samples whose z is outside [0, v_z) or whose x is outside [0, v_x) are
// dropped, from counts and rows alike.
//
// What bounds it: bytes and the atomic units. The ids are read once
// (8 bytes a sample: 2 MB for the main path's 262,144-sample window) and
// the (v_z, v_x) counts (725 KB at 7548 x 24) are written through
// atomics that resolve in L2.
//
// Design: the TPU kernel builds one-hot tiles and contracts them on the
// MXU, because the TPU has no fast scatter. Hopper does: one thread per
// sample (grid-stride), one fire-and-forget f32 atomicAdd into counts
// and one into rows. Adding 1.0f to integer-valued floats below 2^24 is
// exact in any order, so the result equals the plain version bit for
// bit. Privatising counts in shared memory does not fit at the main
// path's shape (7548 x 24 x 4 B > 227 KB) and is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

__global__ void histogram_kernel(const int32_t* __restrict__ z, const int32_t* __restrict__ x,
                                 float* __restrict__ counts, float* __restrict__ rows,
                                 long long n, int v_z, int v_x) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; s < n;
       s += stride) {
    const int zi = __ldg(z + s);
    const int xi = __ldg(x + s);
    if (zi < 0 || zi >= v_z || xi < 0 || xi >= v_x) continue;
    atomicAdd(counts + static_cast<size_t>(zi) * v_x + xi, 1.0f);
    if (rows != nullptr) atomicAdd(rows + zi, 1.0f);
  }
}

}  // namespace

extern "C" int fm_histogram(const void* z, const void* x, void* counts, void* rows,
                            long long n, int v_z, int v_x, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  histogram_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(z), static_cast<const int32_t*>(x),
      static_cast<float*>(counts), static_cast<float*>(rows), n, v_z, v_x);
  return static_cast<int>(cudaGetLastError());
}
