"""CUDA kernel A: AnyActive block marking over a packed bitmap.

Port of `repro.kernels.anyactive`. The paper's Algorithm 3 marks a
lookahead window of data blocks for :read/:skip by testing whether any
active candidate has a tuple in the block: a bitwise AND of the block's
packed presence row with the packed active mask, reduced by OR. Kernel
A does it with one warp per row and a warp vote (``csrc/anyactive.cu``).

Packed words are int32 tensors carrying the uint32 bit pattern (PyTorch
lacks the uint32 operations this needs). The plain version is
`repro_torch.kernels.ref.anyactive_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

__all__ = ["anyactive", "KERNEL"]

KERNEL = CudaKernel(
    "anyactive",
    "fm_anyactive",
    (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int),
)


def anyactive(bitmap: torch.Tensor, active_words: torch.Tensor) -> torch.Tensor:
    """(num_blocks,) bool marks: True = :read, False = :skip.

    bitmap: (num_blocks, W) int32; active_words: (W,) int32; both
    contiguous on the current CUDA device.
    """
    check_cuda_tensor(bitmap, "bitmap", torch.int32, 2)
    check_cuda_tensor(active_words, "active_words", torch.int32, 1)
    rows, words = bitmap.shape
    if active_words.shape[0] != words:
        raise ValueError(f"active_words has {active_words.shape[0]} words, bitmap {words}")
    out = torch.empty((rows,), dtype=torch.bool, device=bitmap.device)
    if rows == 0:
        return out
    if words == 0:
        return out.zero_()
    KERNEL.launch(bitmap.data_ptr(), active_words.data_ptr(), out.data_ptr(), rows, words)
    return out
