"""CUDA kernel A: a round's block marking, AnyActive over a packed bitmap.

Port of `repro.kernels.anyactive`. The paper's Algorithm 3 marks a
lookahead window of data blocks for :read/:skip by testing whether any
active candidate has a tuple in the block: a bitwise AND of the block's
packed presence row with the packed active mask, reduced by OR.

Kernel A (``csrc/anyactive.cu``) does the round's whole marking in one
launch: `mark_blocks` takes the window's block ids, its validity, the
cursor's read mask and either the whole resident bitmap table (rows read
in place through the ids) or a window of rows already gathered, and
returns the final marks; without a bitmap it returns the scan policy's
marks. `anyactive` is the same launch with no ids, validity or read
mask, the counterpart of `anyactive_pallas`.

Packed words are int32 tensors carrying the uint32 bit pattern (PyTorch
lacks the uint32 operations this needs). The plain versions are
`repro_torch.kernels.ref.mark_blocks_ref` and `anyactive_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaKernel, check_cuda_tensor

__all__ = ["anyactive", "mark_blocks", "KERNEL"]

_P = ctypes.c_void_p
KERNEL = CudaKernel(
    "anyactive",
    "fm_mark_blocks",
    (_P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int),
)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(rows: int, words: int, *, indices=None, valid=None, read_mask=None,
            bitmap=None, active_words=None, by_id=False) -> torch.Tensor:
    device = (indices if indices is not None else bitmap).device
    out = torch.empty((rows,), dtype=torch.bool, device=device)
    if rows == 0:
        return out
    if bitmap is not None and words == 0:
        return out.zero_()  # no candidate: nothing is active
    num_ids = read_mask.shape[0] if read_mask is not None else rows
    KERNEL.launch(_ptr(indices), _ptr(valid), _ptr(read_mask), _ptr(bitmap),
                  _ptr(active_words), out.data_ptr(), rows, words, num_ids, int(by_id))
    return out


def _check_bitmap(bitmap: torch.Tensor, active_words: torch.Tensor) -> int:
    check_cuda_tensor(bitmap, "bitmap", torch.int32, 2)
    check_cuda_tensor(active_words, "active_words", torch.int32, 1)
    words = bitmap.shape[1]
    if active_words.shape[0] != words:
        raise ValueError(f"active_words has {active_words.shape[0]} words, bitmap {words}")
    return words


def anyactive(bitmap: torch.Tensor, active_words: torch.Tensor) -> torch.Tensor:
    """(num_blocks,) bool marks: True = :read, False = :skip.

    bitmap: (num_blocks, W) int32; active_words: (W,) int32; both
    contiguous on the current CUDA device.
    """
    words = _check_bitmap(bitmap, active_words)
    return _launch(bitmap.shape[0], words, bitmap=bitmap, active_words=active_words)


def mark_blocks(
    indices: torch.Tensor,
    valid: torch.Tensor,
    read_mask: torch.Tensor,
    bitmap: Optional[torch.Tensor] = None,
    active_words: Optional[torch.Tensor] = None,
    *,
    by_id: bool = False,
) -> torch.Tensor:
    """(L,) bool final read-marks of a window, one launch:

        valid & ~read_mask[indices] & any_w(row_i & active_words)

    indices: (L,) int64 block ids; valid: (L,) bool; read_mask:
    (num_blocks,) bool. ``row_i`` is ``bitmap[indices[i]]`` when
    ``by_id`` (``bitmap`` is the whole (num_blocks, W) table) and
    ``bitmap[i]`` otherwise (an (L, W) window already gathered). With no
    bitmap and no active words the result is ``valid &
    ~read_mask[indices]``. Ids must lie in [0, num_blocks); the kernel
    marks any other id False (the plain version raises).
    """
    check_cuda_tensor(indices, "indices", torch.int64, 1)
    check_cuda_tensor(valid, "valid", torch.bool, 1)
    check_cuda_tensor(read_mask, "read_mask", torch.bool, 1)
    rows = indices.shape[0]
    if valid.shape[0] != rows:
        raise ValueError(f"valid has {valid.shape[0]} rows, indices {rows}")
    if (bitmap is None) != (active_words is None):
        raise ValueError("give both bitmap and active_words, or neither")
    words = 0
    if bitmap is not None:
        words = _check_bitmap(bitmap, active_words)
        want = read_mask.shape[0] if by_id else rows
        if bitmap.shape[0] != want:
            raise ValueError(
                f"bitmap has {bitmap.shape[0]} rows; by_id={by_id} needs {want}"
            )
    return _launch(rows, words, indices=indices, valid=valid, read_mask=read_mask,
                   bitmap=bitmap, active_words=active_words, by_id=by_id)
