"""uint32 lanes carried as int32 tensors.

PyTorch has no popcount, and on the CPU its uint32 shifts and compares
raise NotImplementedError.  So packed words live in int32 tensors holding
the same bits, and the JAX package's unsigned lane arithmetic is written
with the helpers below: a logical right shift (arithmetic shift, then a
mask of the bits the sign could have filled) and a SWAR popcount.  Hex
constants with bit 31 set are passed through `i32` to their signed value.
"""

from __future__ import annotations

import numpy as np
import torch


def i32(v: int) -> int:
    """The int32 value with the bits of the uint32 constant `v`."""
    return v - (1 << 32) if v >= 1 << 31 else v


def from_numpy_u32(a: np.ndarray) -> torch.Tensor:
    """uint32 array -> int32 CPU tensor with the same bits (a view where
    the array is contiguous and writable, else one copy)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a.view(np.int32))


def to_numpy_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor (any device) -> host uint32 array with the same bits."""
    return t.detach().cpu().numpy().view(np.uint32)


def srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 lanes by 0 < n < 32 bits."""
    return (x >> n) & ((1 << (32 - n)) - 1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits per int32 lane (SWAR).  After the nibble step every byte
    holds at most 8, so the final byte sum uses plain shifts and cannot
    overflow."""
    x = x - (srl(x, 1) & 0x55555555)
    x = (x & 0x33333333) + (srl(x, 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F
