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
// skips the row sums; a null z reads every sample's row as 0 (a V_Z = 1
// histogram needs only its x ids). Samples whose z is outside [0, v_z)
// or whose x is outside [0, v_x) are dropped, from both outputs.
//
// What bounds it on the H100: bytes, latency and, where the samples
// crowd onto few bins, atomic contention. The op must read the ids (8
// bytes a sample, 4 without z) and counts and n, and write counts and n
// once: 3.6 MB at the main path's 262,144 samples into 7548 x 24, about
// 1.1 us at 3.35 TB/s; 2.35 MB of x ids at the drift monitor's 587,776
// samples into (1, 64), 0.70 us.
//
// Two forms; the caller picks one (`form`, from `kernels/histogram.py`'s
// rule on (v_z, v_x)):
//
// The global form, for counts too large for a block's shared memory
// (the main path's 7548 x 24), in two phases around a grid-wide barrier:
//  1. Scatter. Threads stride over the samples, 16 bytes of ids a load
//     where the id arrays are aligned, and each kept sample makes one
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
//
// The private form, for counts that fit a block (up to the rule's 8,192
// bins: the drift monitor's (1, 64), the registry's (1, 14), the corpus
// selection's 64 x 128). With every sample on a few addresses the global
// form's L2 atomics serialise (224 us at (1, 64) on crowded ids), so:
//  1. Count privately. Each block zeroes a uint32 histogram in shared
//     memory, one replica a warp up to kReplicaBins bins (one copy
//     above), and takes a contiguous chunk of about kSamplesPerBlock
//     samples, so a block of the corpus's one-domain runs touches few
//     rows. Threads load 16 bytes of ids at a time where they are
//     aligned; out-of-range ids drop; each kept sample is one shared
//     atomic into the warp's replica.
//  2. Merge. Each block adds only its nonzero bins into the global
//     scratch, read as uint32 (exact to 2^32), one atomic a bin.
//  3. Flush. After the grid.sync() of a cooperative launch, a warp a
//     row writes counts_in + delta as f32 and n_in + the row sum, and
//     zeroes the scratch. A grid of one block (the registry's few
//     samples) flushes straight from shared memory, touches no scratch
//     and launches plainly.
// What it pays: the launch, one pass over the ids, and a merge and flush
// that grow with the bins, so it loses to the global form from 16,384
// bins on uniform ids (H100, 700 W, tools/torch_hist_forms.py). The
// alternatives that measured slower there (warp-aggregated atomics or
// per-thread counter columns for the scatter, a cluster merge in
// distributed shared memory, a last-block ticket for the grid.sync())
// live in tools/hist_variants.cu, not here.
//
// Adding integer-valued floats below 2^24 is exact in any order, so both
// forms equal the plain version bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// rows up to this wide are flushed by one thread each, from registers
constexpr int kThreadRow = 32;

// `form`: the global form or the private form
constexpr int kFormGlobal = 0;
constexpr int kFormPrivate = 1;
// a replica of the private histogram a warp up to this many bins
constexpr int kReplicaBins = 1024;
// samples a block of the private form takes (16 a thread)
constexpr long long kSamplesPerBlock = 4096;
constexpr int kUnroll = 4;

struct Ingest {
  const int32_t* z;  // null: row 0 for every sample (v_z == 1)
  const int32_t* x;
  const float* counts_in;  // null: zero
  const float* n_in;       // null: zero
  float* counts_out;
  float* n_out;  // null: no row sums
  float* delta;  // (v_z, v_x), all zero on entry and on exit
  long long n;
  int v_z;
  int v_x;
  bool vec;  // v_x % 4 == 0 and every row pointer 16-byte aligned
  // the private form
  bool vec_ids;  // x (and z) 16-byte aligned
  int bins;      // v_z * v_x
  int replicas;  // of the histogram: kWarps or 1
  int rows_words, smem_words;  // shared memory layout, in words
};

// ---------------------------------------------------------------------------
// the global form

template <bool kHasZ>
__device__ __forceinline__ void scatter_one(const Ingest& a, int zi, int xi) {
  if (static_cast<unsigned>(zi) < static_cast<unsigned>(a.v_z) &&
      static_cast<unsigned>(xi) < static_cast<unsigned>(a.v_x)) {
    atomicAdd(a.delta + (kHasZ ? static_cast<size_t>(zi) * a.v_x : 0) + xi, 1.0f);
  }
}

template <bool kHasZ>
__device__ void scatter(const Ingest& a, long long tid, long long stride) {
  long long head = 0;
  if (((reinterpret_cast<uintptr_t>(a.z) | reinterpret_cast<uintptr_t>(a.x)) & 15) == 0) {
    const long long n4 = a.n / 4;
    const int4* z4 = reinterpret_cast<const int4*>(a.z);
    const int4* x4 = reinterpret_cast<const int4*>(a.x);
    for (long long i = tid; i < n4; i += stride) {
      const int4 zv = kHasZ ? __ldg(z4 + i) : make_int4(0, 0, 0, 0);
      const int4 xv = __ldg(x4 + i);
      scatter_one<kHasZ>(a, zv.x, xv.x);
      scatter_one<kHasZ>(a, zv.y, xv.y);
      scatter_one<kHasZ>(a, zv.z, xv.z);
      scatter_one<kHasZ>(a, zv.w, xv.w);
    }
    head = n4 * 4;
  }
  for (long long s = head + tid; s < a.n; s += stride) {
    scatter_one<kHasZ>(a, kHasZ ? __ldg(a.z + s) : 0, __ldg(a.x + s));
  }
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
  if (a.vec) {
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
template <bool kHasZ>
__global__ void ingest_kernel(Ingest a) {
  scatter<kHasZ>(a, static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x,
                 static_cast<long long>(gridDim.x) * blockDim.x);
  cg::this_grid().sync();
  flush(a, static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x,
        static_cast<long long>(gridDim.x) * (blockDim.x >> 5));
}

// ---------------------------------------------------------------------------
// the private form

// The sample's bin, or -1 where its z or x lies out of range.
__device__ __forceinline__ int bin_of(const Ingest& a, int zi, int xi) {
  return static_cast<unsigned>(zi) < static_cast<unsigned>(a.v_z) &&
                 static_cast<unsigned>(xi) < static_cast<unsigned>(a.v_x)
             ? zi * a.v_x + xi
             : -1;
}

// One sample into the warp's replica of the block's histogram (bin -1:
// no sample).
__device__ __forceinline__ void count(unsigned* hist, int b) {
  if (b >= 0) atomicAdd(hist + b, 1u);
}

// The block's contiguous chunk of the samples into its histogram, with
// kUnroll loads in flight a thread.
template <bool kHasZ>
__device__ void private_scatter(const Ingest& a, unsigned* hist) {
  unsigned* rep = hist + (static_cast<int>(threadIdx.x >> 5) % a.replicas) * a.bins;
  const long long units = a.vec_ids ? a.n / 4 : a.n;
  const long long per = (units + gridDim.x - 1) / gridDim.x;
  const long long lo = per * blockIdx.x;
  const long long hi = lo + per < units ? lo + per : units;
  if (a.vec_ids) {
    const int4* x4 = reinterpret_cast<const int4*>(a.x);
    const int4* z4 = reinterpret_cast<const int4*>(a.z);
    for (long long base = lo; base < hi; base += kThreads * kUnroll) {
      int4 xv[kUnroll], zv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long u = base + k * kThreads + threadIdx.x;
        xv[k] = make_int4(-1, -1, -1, -1);
        zv[k] = make_int4(0, 0, 0, 0);
        if (u < hi) {
          xv[k] = __ldg(x4 + u);
          if (kHasZ) zv[k] = __ldg(z4 + u);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        count(rep, bin_of(a, zv[k].x, xv[k].x));
        count(rep, bin_of(a, zv[k].y, xv[k].y));
        count(rep, bin_of(a, zv[k].z, xv[k].z));
        count(rep, bin_of(a, zv[k].w, xv[k].w));
      }
    }
    // the last n % 4 samples, by the last block's first warp
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x < 32) {
      const long long s = units * 4 + threadIdx.x;
      if (s < a.n) count(rep, bin_of(a, kHasZ ? __ldg(a.z + s) : 0, __ldg(a.x + s)));
    }
  } else {
    for (long long base = lo; base < hi; base += kThreads * kUnroll) {
      int xv[kUnroll], zv[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const long long s = base + k * kThreads + threadIdx.x;
        xv[k] = -1;
        zv[k] = 0;
        if (s < hi) {
          xv[k] = __ldg(a.x + s);
          if (kHasZ) zv[k] = __ldg(a.z + s);
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) count(rep, bin_of(a, zv[k], xv[k]));
    }
  }
}

// The block's count of bin j: its replicas summed.
__device__ __forceinline__ unsigned block_total(const Ingest& a, const unsigned* hist, int j) {
  unsigned v = 0;
  for (int r = 0; r < a.replicas; ++r) v += hist[r * a.bins + j];
  return v;
}

// The outputs of a grid of one block, from its own histogram:
// counts_in + delta and n_in + the row sums. `rows` (shared, zero on
// entry) gathers the row sums.
__device__ void flush_block(const Ingest& a, unsigned* rows, const unsigned* hist) {
  constexpr int kU = 8;
  int cur = -1;
  unsigned acc = 0;
  for (int base = threadIdx.x; base < a.bins; base += kThreads * kU) {
    unsigned d[kU];
    float c[kU];
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int j = base + k * kThreads;
      d[k] = 0u;
      c[k] = 0.0f;
      if (j < a.bins) {
        d[k] = block_total(a, hist, j);
        if (a.counts_in != nullptr) c[k] = __ldg(a.counts_in + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int j = base + k * kThreads;
      if (j < a.bins) {
        a.counts_out[j] = c[k] + static_cast<float>(d[k]);
        const int r = j / a.v_x;
        if (r != cur) {
          if (acc != 0u) atomicAdd(rows + cur, acc);
          cur = r;
          acc = 0u;
        }
        acc += d[k];
      }
    }
  }
  if (acc != 0u) atomicAdd(rows + cur, acc);
  __syncthreads();
  if (a.n_out != nullptr) {
    for (int r = threadIdx.x; r < a.v_z; r += kThreads) {
      a.n_out[r] = (a.n_in != nullptr ? __ldg(a.n_in + r) : 0.0f) + static_cast<float>(rows[r]);
    }
  }
}

// The outputs, by every block after grid.sync(): a warp a row, the rows
// interleaved over the grid's warps; the scratch, read as uint32, left
// zero.
__device__ void flush_grid(const Ingest& a, long long warp, long long warps) {
  unsigned* g = reinterpret_cast<unsigned*>(a.delta);
  const int lane = threadIdx.x & 31;
  for (long long r = warp; r < a.v_z; r += warps) {
    const size_t base = static_cast<size_t>(r) * a.v_x;
    const float n0 = lane == 0 ? row_n_in(a, r) : 0.0f;
    unsigned sum = 0u;
    for (int j = lane; j < a.v_x; j += 32) {
      const unsigned d = __ldcg(g + base + j);
      const float c = a.counts_in != nullptr ? __ldg(a.counts_in + base + j) : 0.0f;
      sum += d;
      a.counts_out[base + j] = c + static_cast<float>(d);
      __stcg(g + base + j, 0u);
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && a.n_out != nullptr) a.n_out[r] = n0 + static_cast<float>(sum);
  }
}

// Count privately, add the nonzero bins into the scratch, grid.sync(),
// flush; a grid of one block flushes from shared memory instead. Shared
// memory: the row sums (rows_words), then the histogram.
template <bool kHasZ>
__global__ void __launch_bounds__(kThreads) private_kernel(Ingest a) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* rows = smem;
  unsigned* hist = smem + a.rows_words;
  for (int i = threadIdx.x; i < a.smem_words / 4; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  private_scatter<kHasZ>(a, hist);
  __syncthreads();
  if (gridDim.x == 1) {
    flush_block(a, rows, hist);
    return;
  }
  unsigned* g = reinterpret_cast<unsigned*>(a.delta);
  for (int j = threadIdx.x; j < a.bins; j += kThreads) {
    const unsigned v = block_total(a, hist, j);
    if (v != 0u) atomicAdd(g + j, v);
  }
  cg::this_grid().sync();
  flush_grid(a, static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x,
             static_cast<long long>(gridDim.x) * kWarps);
}

// ---------------------------------------------------------------------------
// launches

int device_attr(cudaDeviceAttr attr) {
  static int cached[64][2] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  const int slot = attr == cudaDevAttrMultiProcessorCount ? 0 : 1;
  if (cached[dev][slot] == 0) cudaDeviceGetAttribute(&cached[dev][slot], attr, dev);
  return cached[dev][slot];
}

// Blocks of kThreads that fit on the current device at once.
long long resident_blocks() {
  static int cached[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (cached[dev] == 0) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ingest_kernel<true>, kThreads, 0);
    const int sms = device_attr(cudaDevAttrMultiProcessorCount);
    cached[dev] = sms * per_sm > 0 ? sms * per_sm : 1;
  }
  return cached[dev];
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch_global(const Ingest& a, cudaStream_t stream) {
  // enough threads for 4 samples or one row each, at most one full wave
  long long blocks = (a.n / 4 + kThreads - 1) / kThreads;
  const long long row_blocks = (a.v_z + kThreads - 1) / kThreads;
  if (blocks < row_blocks) blocks = row_blocks;
  if (blocks > resident_blocks()) blocks = resident_blocks();
  if (blocks < 1) blocks = 1;
  Ingest arg = a;
  void* args[] = {&arg};
  const void* fn = a.z != nullptr ? reinterpret_cast<const void*>(ingest_kernel<true>)
                                  : reinterpret_cast<const void*>(ingest_kernel<false>);
  return static_cast<int>(cudaLaunchCooperativeKernel(
      fn, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), args, 0, stream));
}

// The grid sized to the work: a block a kSamplesPerBlock samples, at
// most two a multiprocessor (so few merges), at least one. A grid of one
// block never reaches grid.sync() and launches plainly.
template <bool kHasZ>
int launch_private(Ingest a, cudaStream_t stream) {
  auto kernel = private_kernel<kHasZ>;
  a.replicas = a.bins <= kReplicaBins ? kWarps : 1;
  // every part a whole number of 16-byte words
  const long long rows_words = (a.v_z + 3LL) & ~3LL;
  const long long hist_words = (static_cast<long long>(a.bins) * a.replicas + 3) & ~3LL;
  const long long words = rows_words + hist_words;
  const int limit = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  if (words * 4 > limit) return static_cast<int>(cudaErrorInvalidValue);
  a.rows_words = static_cast<int>(rows_words);
  a.smem_words = static_cast<int>(words);
  const size_t smem = static_cast<size_t>(words) * 4;
  // per device: the opt-in made, and the blocks an SM holds at occ_smem
  static bool opted[64] = {};
  static size_t occ_smem[64] = {};
  static int occ_blocks[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!opted[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted[dev] = true;
  }
  const int sms = device_attr(cudaDevAttrMultiProcessorCount);
  long long blocks = (a.n + kSamplesPerBlock - 1) / kSamplesPerBlock;
  if (blocks > 2LL * sms) blocks = 2LL * sms;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  if (blocks == 1) {
    private_kernel<kHasZ><<<grid, block, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  // a cooperative grid must fit the co-resident blocks
  if (occ_smem[dev] != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks[dev], kernel, kThreads, smem);
    occ_smem[dev] = smem;
  }
  if (blocks > static_cast<long long>(occ_blocks[dev]) * sms) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), grid,
                                                      block, args, smem, stream));
}

}  // namespace

// `form` 0: the global form; 1: the private form (up to the shared
// memory of a block). A null z reads every sample's row as 0, which the
// caller passes only at v_z == 1.
extern "C" int fm_ingest(const void* z, const void* x, const void* counts_in, const void* n_in,
                         void* counts_out, void* n_out, void* delta, long long n, int v_z,
                         int v_x, int form, void* stream) {
  Ingest a = {};
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
  a.vec = v_x % 4 == 0 && aligned16(delta) && aligned16(counts_out) &&
          (counts_in == nullptr || aligned16(counts_in));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kFormGlobal) return launch_global(a, s);
  if (form != kFormPrivate) return static_cast<int>(cudaErrorInvalidValue);
  const long long bins = static_cast<long long>(v_z) * v_x;
  if (bins > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  a.bins = static_cast<int>(bins);
  a.vec_ids = aligned16(x) && aligned16(z);
  return z != nullptr ? launch_private<true>(a, s) : launch_private<false>(a, s);
}
