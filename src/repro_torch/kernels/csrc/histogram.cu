// Kernel B: the fused ingest. One C call adds a batch of (z, x) id pairs
// into the counts and their row sums, functionally:
//
//   counts_out[z, x] = counts_in[z, x] + #{s : (z_s, x_s) = (z, x)}
//   n_out[z]         = n_in[z]         + #{s : z_s = z}
//
// Replaces the Pallas kernel `_histogram_kernel` of
// src/repro/kernels/histogram.py:44 (pallas_call at :108) together with
// the two adds of the reference's `ingest` (src/repro/core/multiquery.py
// :455-473). A null counts_in or n_in reads as zero, which gives the
// reference's fresh `histogram` / `histogram_with_rowsums`; a null n_out
// skips the row sums. Samples whose z is outside [0, v_z) or whose x is
// outside [0, v_x) are dropped, from both outputs.
//
// What bounds it on the H100: bytes and latency. The op must read the
// ids (8 bytes a sample: 2 MB for the main path's 262,144-sample window)
// and counts and n, and write counts and n once (1.5 MB at 7548 x 24):
// 3.6 MB, about 1.1 us at 3.35 TB/s. The atomics resolve in L2.
//
// Design, in two phases around a grid-wide barrier:
//  1. Scatter. Threads stride over the samples, 16 bytes of ids a load
//     where both id arrays are aligned, and each kept sample makes one
//     fire-and-forget f32 atomic add into `delta`, a (v_z, v_x) scratch
//     that the wrapper keeps per (device, stream, shape). It stays in the
//     50 MB L2. No atomic touches the row sums: a second atomic per
//     sample into only v_z addresses doubled the old kernel's time.
//  2. Flush. Each thread owns a row (a warp owns a row when v_x > 32),
//     sums its delta in a fixed order, writes counts_in + delta and
//     n_in + sum, and writes the delta row back to zero, so the scratch
//     is all zero again when the call ends and no memset is launched.
// The barrier is the grid.sync() of a cooperative launch whose grid fits
// the co-resident blocks: on an H100 (700 W) the whole call took 8.91 us
// against 9.40 us with the flush as a second launch. Of the ~8.7 us at
// the main path's shape, the launch and grid.sync() take ~3.2 us, the
// scatter ~3.4 us and the flush ~2 us (the same card).
// Adding integer-valued floats below 2^24 is exact in any order, so both
// outputs equal the plain version bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// rows up to this wide are flushed by one thread each, from registers
constexpr int kThreadRow = 32;

struct Ingest {
  const int32_t* z;
  const int32_t* x;
  const float* counts_in;  // null: zero
  const float* n_in;       // null: zero
  float* counts_out;
  float* n_out;  // null: no row sums
  float* delta;  // (v_z, v_x), all zero on entry and on exit
  long long n;
  int v_z;
  int v_x;
  bool vec4;  // v_x % 4 == 0 and every row pointer 16-byte aligned
};

__device__ __forceinline__ void scatter_one(const Ingest& a, int zi, int xi) {
  if (static_cast<unsigned>(zi) < static_cast<unsigned>(a.v_z) &&
      static_cast<unsigned>(xi) < static_cast<unsigned>(a.v_x)) {
    atomicAdd(a.delta + static_cast<size_t>(zi) * a.v_x + xi, 1.0f);
  }
}

__device__ void scatter(const Ingest& a, long long tid, long long stride) {
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(a.z) | reinterpret_cast<uintptr_t>(a.x)) & 15) == 0) {
    const long long n4 = a.n / 4;
    const int4* z4 = reinterpret_cast<const int4*>(a.z);
    const int4* x4 = reinterpret_cast<const int4*>(a.x);
    for (long long i = tid; i < n4; i += stride) {
      const int4 zv = __ldg(z4 + i);
      const int4 xv = __ldg(x4 + i);
      scatter_one(a, zv.x, xv.x);
      scatter_one(a, zv.y, xv.y);
      scatter_one(a, zv.z, xv.z);
      scatter_one(a, zv.w, xv.w);
    }
    head = n4 * 4;
  }
  for (long long s = head + tid; s < a.n; s += stride) scatter_one(a, __ldg(a.z + s), __ldg(a.x + s));
}

// n_in[r] (zero without it), loaded with the row's other inputs before
// any store: a load after the stores would wait a second round trip.
__device__ __forceinline__ float row_n_in(const Ingest& a, long long r) {
  return a.n_out != nullptr && a.n_in != nullptr ? __ldg(a.n_in + r) : 0.0f;
}

// A row of at most kThreadRow floats, flushed by one thread: every load
// is issued before the first store, so the row costs one memory round trip.
__device__ void flush_thread_row(const Ingest& a, long long r) {
  const size_t base = static_cast<size_t>(r) * a.v_x;
  const float n0 = row_n_in(a, r);
  float sum = 0.0f;
  if (a.vec4) {
    constexpr int kChunks = kThreadRow / 4;
    const int chunks = a.v_x / 4;
    float4* d = reinterpret_cast<float4*>(a.delta + base);
    const float4* in = reinterpret_cast<const float4*>(a.counts_in + base);
    float4* out = reinterpret_cast<float4*>(a.counts_out + base);
    float4 v[kChunks], c[kChunks];
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j < chunks) {
        v[j] = __ldcg(d + j);
        c[j] = a.counts_in != nullptr ? __ldg(in + j) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      if (j < chunks) {
        sum += ((v[j].x + v[j].y) + v[j].z) + v[j].w;
        out[j] = make_float4(c[j].x + v[j].x, c[j].y + v[j].y, c[j].z + v[j].z, c[j].w + v[j].w);
        __stcg(d + j, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  } else {
    float* d = a.delta + base;
    float v[kThreadRow], c[kThreadRow];
#pragma unroll
    for (int j = 0; j < kThreadRow; ++j) {
      if (j < a.v_x) {
        v[j] = __ldcg(d + j);
        c[j] = a.counts_in != nullptr ? __ldg(a.counts_in + base + j) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kThreadRow; ++j) {
      if (j < a.v_x) {
        sum += v[j];
        a.counts_out[base + j] = c[j] + v[j];
        __stcg(d + j, 0.0f);
      }
    }
  }
  if (a.n_out != nullptr) a.n_out[r] = n0 + sum;
}

// A wider row, flushed by a whole warp striding over it.
__device__ void flush_warp_row(const Ingest& a, long long r, int lane) {
  const size_t base = static_cast<size_t>(r) * a.v_x;
  float* d = a.delta + base;
  const float n0 = lane == 0 ? row_n_in(a, r) : 0.0f;
  float sum = 0.0f;
  for (int j = lane; j < a.v_x; j += 32) {
    const float v = __ldcg(d + j);
    const float c = a.counts_in != nullptr ? __ldg(a.counts_in + base + j) : 0.0f;
    sum += v;
    a.counts_out[base + j] = c + v;
    __stcg(d + j, 0.0f);
  }
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0 && a.n_out != nullptr) a.n_out[r] = n0 + sum;
}

// Warp `warp` of `warps` flushes rows warp*32 .. warp*32+31 (a thread
// each), then the next 32 rows `warps` further on; or row warp, warp +
// warps, ... (a warp each).
__device__ void flush(const Ingest& a, long long warp, long long warps) {
  const int lane = threadIdx.x & 31;
  if (a.v_x <= kThreadRow) {
    for (long long w = warp; w * 32 < a.v_z; w += warps) {
      const long long r = w * 32 + lane;
      if (r < a.v_z) flush_thread_row(a, r);
    }
  } else {
    for (long long r = warp; r < a.v_z; r += warps) flush_warp_row(a, r, lane);
  }
}

// Phase 1, grid.sync(), phase 2. The warps of the grid interleave in
// phase 2 (warp w of block b is warp w * grid + b), so the flush spreads
// over every block.
__global__ void ingest_kernel(Ingest a) {
  scatter(a, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
          static_cast<long long>(gridDim.x) * blockDim.x);
  cooperative_groups::this_grid().sync();
  flush(a, static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x,
        static_cast<long long>(gridDim.x) * (blockDim.x >> 5));
}

// Blocks of kThreads that fit on the current device at once.
long long resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ingest_kernel, kThreads, 0);
    cached[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return cached[dev];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int fm_ingest(const void* z, const void* x, const void* counts_in, const void* n_in,
                         void* counts_out, void* n_out, void* delta, long long n, int v_z,
                         int v_x, void* stream) {
  Ingest a;
  a.z = static_cast<const int32_t*>(z);
  a.x = static_cast<const int32_t*>(x);
  a.counts_in = static_cast<const float*>(counts_in);
  a.n_in = static_cast<const float*>(n_in);
  a.counts_out = static_cast<float*>(counts_out);
  a.n_out = static_cast<float*>(n_out);
  a.delta = static_cast<float*>(delta);
  a.n = n;
  a.v_z = v_z;
  a.v_x = v_x;
  a.vec4 = v_x % 4 == 0 && aligned16(delta) && aligned16(counts_out) &&
           (counts_in == nullptr || aligned16(counts_in));
  // enough threads for 4 samples or one row each, at most one full wave
  long long blocks = (n / 4 + kThreads - 1) / kThreads;
  const long long row_blocks = (v_z + kThreads - 1) / kThreads;
  if (blocks < row_blocks) blocks = row_blocks;
  if (blocks > resident_blocks()) blocks = resident_blocks();
  if (blocks < 1) blocks = 1;
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(ingest_kernel), dim3(static_cast<unsigned>(blocks)), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream)));
}
