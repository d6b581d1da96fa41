// Kernel B's private form with the alternative steps it was measured
// against, for tools/torch_hist_forms.py alone: nothing in the port
// builds or calls this file. The production kernel,
// src/repro_torch/kernels/csrc/histogram.cu, keeps only the steps that
// measured fastest on an H100 (variant 0 here). The bits of `form` swap
// a step for its alternative:
//  - kColumns: per-thread counter columns in shared memory, no atomics,
//    for the scatter's shared atomics;
//  - kMatch: a warp aggregating equal bins first (`__match_any_sync`,
//    the leader adds the popcount), for the scatter's shared atomics;
//  - kCluster: a 4-block cluster summing its blocks' totals in
//    distributed shared memory before the global atomics, for the
//    per-block merge (with the ticket flush: a cluster launch is not
//    cooperative);
//  - kTicket: the last block alone flushing after a ticket (an atomic
//    counter, in the word just past the scratch, that it resets), for
//    the cooperative grid.sync() and the flush by every block.
// `blocks` > 0 pins the grid. Same contract as the production entry:
// ids out of range dropped, the scratch (and its ticket word) all zero
// on entry and on exit, bitwise the plain version below 2^24 a cell.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

constexpr int kFormPrivate = 1;
constexpr int kColumns = 2;  // scatter: per-thread counter columns, no atomics
constexpr int kCluster = 4;  // merge: a 4-block cluster sums in shared memory first
constexpr int kTicket = 8;   // flush: the last block alone, after a ticket
constexpr int kMatch = 16;   // scatter: a warp aggregates equal bins first
constexpr int kClusterSize = 4;
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
  unsigned* ticket;  // just past delta, zero on entry and exit (kTicket)
  long long n;
  int v_z;
  int v_x;
  bool vec_ids;  // x (and z) 16-byte aligned
  int bins;      // v_z * v_x
  int replicas;  // of the histogram: kWarps or 1
  int rows_words, hist_words, smem_words;  // shared memory layout, in words
};

// n_in[r] (zero without it), loaded with the row's other inputs before
// any store: a load after the stores would wait a second round trip.
__device__ __forceinline__ float row_n_in(const Ingest& a, long long r) {
  return a.n_out != nullptr && a.n_in != nullptr ? __ldg(a.n_in + r) : 0.0f;
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

// One sample into the block's histogram (bin -1: no sample): a shared
// atomic into the warp's replica. Every lane of the warp calls it
// together.
template <int kVariant>
__device__ __forceinline__ void count(unsigned* hist, int rep, int lane, int b) {
  if constexpr ((kVariant & kColumns) != 0) {
    if (b >= 0) hist[b * kThreads + threadIdx.x] += 1u;
  } else if constexpr ((kVariant & kMatch) != 0) {
    const unsigned peers = __match_any_sync(0xffffffffu, b);
    if (b >= 0 && lane == __ffs(peers) - 1) {
      atomicAdd(hist + rep + b, static_cast<unsigned>(__popc(peers)));
    }
  } else {
    if (b >= 0) atomicAdd(hist + rep + b, 1u);
  }
}

// The block's contiguous chunk of the samples into its histogram, with
// kUnroll loads in flight a thread. The loop bounds are the block's, so
// a warp's lanes run its iterations together.
template <bool kHasZ, int kVariant>
__device__ void private_scatter(const Ingest& a, unsigned* hist) {
  const int lane = threadIdx.x & 31;
  const int rep = (static_cast<int>(threadIdx.x >> 5) % a.replicas) * a.bins;
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
        count<kVariant>(hist, rep, lane, bin_of(a, zv[k].x, xv[k].x));
        count<kVariant>(hist, rep, lane, bin_of(a, zv[k].y, xv[k].y));
        count<kVariant>(hist, rep, lane, bin_of(a, zv[k].z, xv[k].z));
        count<kVariant>(hist, rep, lane, bin_of(a, zv[k].w, xv[k].w));
      }
    }
    // the last n % 4 samples, by the last block's first warp
    if (blockIdx.x == gridDim.x - 1 && threadIdx.x < 32) {
      const long long s = units * 4 + lane;
      int xi = -1, zi = 0;
      if (s < a.n) {
        xi = __ldg(a.x + s);
        if (kHasZ) zi = __ldg(a.z + s);
      }
      count<kVariant>(hist, rep, lane, bin_of(a, zi, xi));
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
      for (int k = 0; k < kUnroll; ++k) {
        count<kVariant>(hist, rep, lane, bin_of(a, zv[k], xv[k]));
      }
    }
  }
}

// The block's count of bin j: its replicas summed, or (kColumns) its 256
// thread columns, read diagonally so a warp's lanes hit 32 banks.
template <int kVariant>
__device__ __forceinline__ unsigned block_total(const Ingest& a, const unsigned* hist, int j) {
  unsigned v = 0;
  if constexpr ((kVariant & kColumns) != 0) {
    const unsigned* col = hist + static_cast<size_t>(j) * kThreads;
    for (int t = 0; t < kThreads; ++t) v += col[(t + j) & (kThreads - 1)];
  } else {
    for (int r = 0; r < a.replicas; ++r) v += hist[r * a.bins + j];
  }
  return v;
}

// The outputs, by one block: counts_in + delta and n_in + the row sums,
// delta read from the block's own histogram (a grid of one block) or
// (kTicket) from the global scratch, which it leaves zero. `rows`
// (shared, zero on entry) gathers the row sums.
template <int kVariant, bool kShared>
__device__ void flush_block(const Ingest& a, unsigned* rows, const unsigned* hist) {
  unsigned* g = reinterpret_cast<unsigned*>(a.delta);
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
        if constexpr (kShared) {
          d[k] = block_total<kVariant>(a, hist, j);
        } else {
          d[k] = __ldcg(g + j);
        }
        if (a.counts_in != nullptr) c[k] = __ldg(a.counts_in + j);
      }
    }
#pragma unroll
    for (int k = 0; k < kU; ++k) {
      const int j = base + k * kThreads;
      if (j < a.bins) {
        a.counts_out[j] = c[k] + static_cast<float>(d[k]);
        if constexpr (!kShared) __stcg(g + j, 0u);
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
// interleaved over the grid's warps; the scratch left zero.
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
// flush. Shared memory: the row sums (rows_words), the histogram
// (hist_words), and under kCluster the block's totals (bins).
template <bool kHasZ, int kVariant>
__global__ void __launch_bounds__(kThreads) private_kernel(Ingest a) {
  constexpr bool kClu = (kVariant & kCluster) != 0;
  constexpr bool kTick = (kVariant & (kTicket | kCluster)) != 0;  // a cluster: no grid.sync()
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ bool last;
  unsigned* rows = smem;
  unsigned* hist = smem + a.rows_words;
  for (int i = threadIdx.x; i < a.smem_words / 4; i += kThreads) {
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  private_scatter<kHasZ, kVariant>(a, hist);
  __syncthreads();
  if constexpr (!kClu) {
    if (gridDim.x == 1) {  // the whole answer is in this block
      flush_block<kVariant, true>(a, rows, hist);
      return;
    }
  }
  unsigned* g = reinterpret_cast<unsigned*>(a.delta);
  if constexpr (kClu) {
    // every block's totals, then each block adds its slice of the bins
    // summed over the cluster
    unsigned* tot = hist + a.hist_words;
    for (int j = threadIdx.x; j < a.bins; j += kThreads) {
      tot[j] = block_total<kVariant>(a, hist, j);
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = static_cast<int>(cluster.block_rank());
    const int slice = (a.bins + kClusterSize - 1) / kClusterSize;
    const int end = (rank + 1) * slice < a.bins ? (rank + 1) * slice : a.bins;
    for (int j = rank * slice + static_cast<int>(threadIdx.x); j < end; j += kThreads) {
      unsigned v = 0u;
      for (int q = 0; q < kClusterSize; ++q) v += cluster.map_shared_rank(tot, q)[j];
      if (v != 0u) atomicAdd(g + j, v);
    }
    cluster.sync();  // no block leaves while another reads its totals
  } else {
    for (int j = threadIdx.x; j < a.bins; j += kThreads) {
      const unsigned v = block_total<kVariant>(a, hist, j);
      if (v != 0u) atomicAdd(g + j, v);
    }
  }
  if constexpr (kTick) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    flush_block<kVariant, false>(a, rows, hist);
    if (threadIdx.x == 0) *a.ticket = 0u;
  } else {
    cg::this_grid().sync();
    flush_grid(a, static_cast<long long>(threadIdx.x >> 5) * gridDim.x + blockIdx.x,
               static_cast<long long>(gridDim.x) * kWarps);
  }
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// One variant of the private form. `blocks` > 0 pins the grid (for
// measurements); 0 sizes it to the work: a block a kSamplesPerBlock
// samples, at most two a multiprocessor (so few merges), at least one.
// A grid of one block never reaches grid.sync() and launches plainly.
template <bool kHasZ, int kVariant>
int launch_private(Ingest a, long long blocks, cudaStream_t stream) {
  constexpr bool kCols = (kVariant & kColumns) != 0;
  constexpr bool kClu = (kVariant & kCluster) != 0;
  constexpr bool kTick = (kVariant & (kTicket | kCluster)) != 0;
  auto kernel = private_kernel<kHasZ, kVariant>;
  a.replicas = !kCols && a.bins <= kReplicaBins ? kWarps : 1;
  // every part a whole number of 16-byte words
  const long long hist = static_cast<long long>(a.bins) * (kCols ? kThreads : a.replicas);
  const long long rows_words = (a.v_z + 3LL) & ~3LL;
  const long long hist_words = (hist + 3) & ~3LL;
  const long long words = rows_words + hist_words + (kClu ? (a.bins + 3LL) & ~3LL : 0);
  // the dynamic part, with room for the kernel's static `last` flag
  const int limit = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin) - 1024;
  if (words * 4 > limit) return static_cast<int>(cudaErrorInvalidValue);
  a.rows_words = static_cast<int>(rows_words);
  a.hist_words = static_cast<int>(hist_words);
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
  if (blocks <= 0) {
    blocks = (a.n + kSamplesPerBlock - 1) / kSamplesPerBlock;
    if (blocks > 2LL * sms) blocks = 2LL * sms;
    if (blocks < 1) blocks = 1;
  }
  if (kClu) blocks = (blocks + kClusterSize - 1) / kClusterSize * kClusterSize;
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  if (kClu) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterSize;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
  }
  if (kTick || blocks == 1) {
    private_kernel<kHasZ, kVariant><<<grid, block, smem, stream>>>(a);
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

template <bool kHasZ>
int launch_private_variant(const Ingest& a, int variant, long long blocks, cudaStream_t stream) {
  switch (variant) {
#define FM_VARIANT(v) \
  case (v): return launch_private<kHasZ, (v)>(a, blocks, stream);
    FM_VARIANT(0)
    FM_VARIANT(kColumns)
    FM_VARIANT(kMatch)
    FM_VARIANT(kTicket)
    FM_VARIANT(kColumns | kTicket)
    FM_VARIANT(kMatch | kTicket)
    FM_VARIANT(kCluster)
    FM_VARIANT(kColumns | kCluster)
    FM_VARIANT(kMatch | kCluster)
#undef FM_VARIANT
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// `form`: the private form's code, bit 0 set, its other bits the variant
// (kColumns, kCluster, kTicket, kMatch). `blocks` > 0 pins the grid, 0
// sizes it. `delta` holds v_z * v_x floats and, just past them, the
// kTicket variant's ticket word.
extern "C" int fm_ingest_variant(const void* z, const void* x, const void* counts_in,
                                 const void* n_in, void* counts_out, void* n_out, void* delta,
                                 long long n, int v_z, int v_x, int form, int blocks,
                                 void* stream) {
  if ((form & kFormPrivate) == 0) return static_cast<int>(cudaErrorInvalidValue);
  Ingest a = {};
  a.z = static_cast<const int32_t*>(z);
  a.x = static_cast<const int32_t*>(x);
  a.counts_in = static_cast<const float*>(counts_in);
  a.n_in = static_cast<const float*>(n_in);
  a.counts_out = static_cast<float*>(counts_out);
  a.n_out = static_cast<float*>(n_out);
  a.delta = static_cast<float*>(delta);
  a.ticket = reinterpret_cast<unsigned*>(a.delta + static_cast<size_t>(v_z) * v_x);
  a.n = n;
  a.v_z = v_z;
  a.v_x = v_x;
  const long long bins = static_cast<long long>(v_z) * v_x;
  if (bins > (1LL << 30)) return static_cast<int>(cudaErrorInvalidValue);
  a.bins = static_cast<int>(bins);
  a.vec_ids = aligned16(x) && aligned16(z);
  const int variant = form & ~kFormPrivate;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return z != nullptr ? launch_private_variant<true>(a, variant, blocks, s)
                      : launch_private_variant<false>(a, variant, blocks, s);
}
