// Kernel A: a round's whole block marking, AnyActive over packed bitmap rows.
//
// Replaces the Pallas kernel `_anyactive_kernel` of
// src/repro/kernels/anyactive.py:26, launched by `anyactive_pallas`
// (pallas_call at :55), together with the ops around it in the
// reference's round, src/repro/core/multiquery.py:644-645:
//
//   marks = mark_window(wd.bitmap, state.union_words, policy=policy)
//   marks = marks & wd.valid & ~cursor.read_mask[wd.indices]
//
// One launch computes, for each of the window's L rows,
//
//   mark[i] = valid[i] & !read_mask[id_i] & any_w (row_i[w] & mask[w]) != 0
//
// where id_i = indices[i] and row_i is bitmap[id_i] when the bitmap is the
// whole resident table (by_id), else bitmap[i] (a window already gathered).
// Each input may be null: no indices reads row i and id i; no valid keeps
// every row; no read_mask reads none as already read; no bitmap leaves
// only valid & !read_mask (the scan policy). With indices, valid and
// read_mask all null this is plain AnyActive over `rows` bitmap rows.
// Words are uint32 (the int32 tensors carry the uint32 bit pattern); bool
// tensors are one byte per element.
//
// What bounds it: bytes, but the bytes are few. At the main path's window
// (512 rows of 236 words at random places in a 737 MB table, far beyond
// the 50 MB L2) the rows it must read are at most 483 KB, about 0.15 us at
// the H100 SXM's data-sheet 3.35 TB/s, while keeping HBM busy needs about
// 2 MB in flight. So the kernel is bound by latency: each row costs a
// chain of dependent round trips (the id, then the read-mask byte, then
// the row), and the design keeps that chain short and runs every row's
// chain at once. TMA would not help: the work is 512 separate 944 B rows,
// not a tile, and a bulk copy would add a shared-memory barrier to the
// chain.
//
// Design: one warp per window row, 4 warps per block, so a 512-row window
// is 128 blocks on the 132 SMs.
// - The lanes first load the mask words they will need (independent of
//   the row, so in flight from the start), the row's id and its validity.
// - A padding row, or a row whose block was read already, writes false
//   and reads no bitmap bytes.
// - When the rows and the mask are 16-byte aligned (W % 4 == 0, as W = 236
//   is), each lane issues all its vector loads of the row (up to kVec
//   uint4, 59 uint4 a row at W = 236, so at most 2 a lane) before it uses
//   any of them, through the read-only path; a wider row takes more trips.
//   Any other W takes the same loop over single words.
// - One warp vote (__any_sync) replaces the TPU's lane-reduction OR.
// No shared memory, no barrier, no atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kVec = 4;  // loads in flight per lane and trip

__device__ __forceinline__ uint32_t and_any(uint4 a, uint4 b) {
  return (a.x & b.x) | (a.y & b.y) | (a.z & b.z) | (a.w & b.w);
}
__device__ __forceinline__ uint32_t and_any(uint32_t a, uint32_t b) { return a & b; }

template <typename V>
__device__ __forceinline__ V zero();
template <>
__device__ __forceinline__ uint4 zero<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ uint32_t zero<uint32_t>() { return 0u; }

// V is uint4 (n = W / 4 vectors a row) or uint32_t (n = W words a row).
template <typename V>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    mark_kernel(const int64_t* __restrict__ indices, const uint8_t* __restrict__ valid,
                const uint8_t* __restrict__ read_mask, const V* __restrict__ bitmap,
                const V* __restrict__ mask, uint8_t* __restrict__ out, int rows, int n,
                long long num_ids, int by_id) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp

  // the first trip's mask words: they do not depend on the row
  V m[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int j = lane + 32 * k;
    m[k] = (bitmap != nullptr && j < n) ? __ldg(mask + j) : zero<V>();
  }
  // every lane loads the same id and flags (one broadcast each), so the
  // tests below are uniform across the warp
  long long id = row;
  bool keep = true;
  if (indices != nullptr) {
    id = __ldg(indices + row);
    keep = id >= 0 && id < num_ids;
  }
  if (valid != nullptr) keep = keep && __ldg(valid + row) != 0;
  if (keep && read_mask != nullptr) keep = __ldg(read_mask + id) == 0;
  if (!keep || bitmap == nullptr) {
    if (lane == 0) out[row] = keep ? 1 : 0;
    return;
  }

  const V* r = bitmap + static_cast<size_t>(by_id ? id : row) * n;
  uint32_t hit = 0;
  for (int base = 0; base < n; base += 32 * kVec) {
    V v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int j = base + lane + 32 * k;
      v[k] = j < n ? __ldg(r + j) : zero<V>();
    }
    if (base > 0) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int j = base + lane + 32 * k;
        m[k] = j < n ? __ldg(mask + j) : zero<V>();
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) hit |= and_any(v[k], m[k]);
  }
  const int any = __any_sync(0xffffffffu, hit != 0u);
  if (lane == 0) out[row] = any ? 1 : 0;
}

}  // namespace

// indices (rows,) int64 or null; valid (rows,) bool or null; read_mask
// (num_ids,) bool or null; bitmap (num_ids or rows, words) uint32 or null,
// with mask (words,) uint32; out (rows,) bool. Ids outside [0, num_ids)
// mark false and read nothing.
extern "C" int fm_mark_blocks(const void* indices, const void* valid, const void* read_mask,
                              const void* bitmap, const void* mask, void* out, int rows,
                              int words, long long num_ids, int by_id, void* stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const dim3 threads(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = words % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(bitmap) | reinterpret_cast<uintptr_t>(mask)) &
                    15u) == 0;
  const int64_t* idx = static_cast<const int64_t*>(indices);
  const uint8_t* ok = static_cast<const uint8_t*>(valid);
  const uint8_t* done = static_cast<const uint8_t*>(read_mask);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (vec) {
    mark_kernel<uint4><<<blocks, threads, 0, s>>>(
        idx, ok, done, static_cast<const uint4*>(bitmap), static_cast<const uint4*>(mask), o,
        rows, words / 4, num_ids, by_id);
  } else {
    mark_kernel<uint32_t><<<blocks, threads, 0, s>>>(
        idx, ok, done, static_cast<const uint32_t*>(bitmap),
        static_cast<const uint32_t*>(mask), o, rows, words, num_ids, by_id);
  }
  return static_cast<int>(cudaGetLastError());
}
