// Kernel A: AnyActive block marking over a packed presence bitmap.
//
// Replaces the Pallas kernel `_anyactive_kernel` of
// src/repro/kernels/anyactive.py:26, launched by `anyactive_pallas`
// (pallas_call at :55).
//
//   mark[b] = any_w (bitmap[b, w] & mask[w]) != 0
//
// bitmap is (rows, words) uint32, mask (words,) uint32; both arrive as
// int32 tensors carrying the uint32 bit pattern. The output is one byte
// per row, written into a torch.bool tensor.
//
// What bounds it: bytes. Each bitmap word is read once and used for one
// AND; at the main path's lookahead window (512 rows of 236 words) that
// is 483 KB, about 0.15 us at the H100 SXM's data-sheet 3.35 TB/s, so a
// launch's fixed cost is larger than its work.
//
// Design: one warp per row. The lanes stride over the row's words, so
// neighbouring lanes read neighbouring words (coalesced), OR their
// partial hits together in a register, and one warp vote (__any_sync)
// replaces the TPU's lane-reduction OR. No shared memory, no atomics;
// the mask is small and served from L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void anyactive_kernel(const uint32_t* __restrict__ bitmap,
                                 const uint32_t* __restrict__ mask,
                                 uint8_t* __restrict__ out, int rows, int words) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // uniform across the warp
  const uint32_t* r = bitmap + static_cast<size_t>(row) * words;
  uint32_t hit = 0;
  for (int w = lane; w < words; w += 32) hit |= __ldg(r + w) & __ldg(mask + w);
  const int any = __any_sync(0xffffffffu, hit != 0u);
  if (lane == 0) out[row] = any ? 1 : 0;
}

}  // namespace

extern "C" int fm_anyactive(const void* bitmap, const void* mask, void* out, int rows,
                            int words, void* stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  anyactive_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bitmap), static_cast<const uint32_t*>(mask),
      static_cast<uint8_t*>(out), rows, words);
  return static_cast<int>(cudaGetLastError());
}
