"""Fused 2-bit pack + bloom validate (kernel A) and its plain version.

Counterpart of shortseq_tpu/ops/bitpack.py pack_and_validate_u32 /
pack_and_validate_rows.  Input: `[N, W4]` uint32 lanes (4 ASCII bytes per
lane, little-endian), carried as int32, and `[N]` int32 lengths.  Output:
`[N, W4 / 4]` packed words (16 codes per lane, LSB first,
code = (c >> 1) & 3) and an `[N]` bool ok mask: a row is ok iff every
byte before its length satisfies (c & 63) in {1, 3, 7, 20}.  With
`pad_valid` the length mask is skipped (the caller promises the tail is
PAD_BYTE).  Words of rows that are not ok are unspecified, as in the JAX
package.

The JAX version's row folding and bf16 "poison" dot existed for the TPU's
128-lane tiles and its matrix unit; neither means anything on Hopper, so
kernel A is one read and one write (shortseq_torch/csrc/kernels.cu, note
A: bound by HBM bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .lanes import from_numpy_u32, srl

# Fail bit (0x40 per byte) mask by the count of row bytes left in a lane.
_TAIL = (0, 0x40, 0x4040, 0x404040, 0x40404040)


def _codes_byte(x: torch.Tensor) -> torch.Tensor:
    """Lanes of 4 ASCII bytes -> their 4 two-bit codes in the low byte."""
    c = srl(x, 1) & 0x03030303
    return (c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xFF


def _bloom_fail_bits(x: torch.Tensor) -> torch.Tensor:
    """0x40 in each byte that fails the bloom: (c & 63) differs from the
    canonical byte rebuilt from its code (codes 0..3 -> 1, 3, 20, 7).  All
    intermediates stay below 2^31, so int32 never overflows here."""
    c = srl(x, 1) & 0x03030303
    t = c << 1
    is2 = (c & ~t) & 0x02020202
    expect = (0x01010101 + t + (is2 << 3)) - (is2 >> 1)
    diff = (x & 0x3F3F3F3F) ^ expect
    return (diff + 0x3F3F3F3F) & 0x40404040


def pack_and_validate_plain(x: torch.Tensor, lengths: torch.Tensor,
                            pad_valid: bool = False):
    """Plain PyTorch version of kernel A (any device)."""
    n, w4 = x.shape
    codes = _codes_byte(x).reshape(n, w4 // 4, 4)
    words = (codes[..., 0] | (codes[..., 1] << 8) | (codes[..., 2] << 16)
             | (codes[..., 3] << 24))
    fail = _bloom_fail_bits(x)
    if not pad_valid:
        lane = torch.arange(w4, dtype=torch.int32, device=x.device)
        rem = (lengths.to(torch.int32)[:, None] - 4 * lane).clamp(0, 4)
        tail = torch.tensor(_TAIL, dtype=torch.int32, device=x.device)
        fail = fail & tail[rem.long()]
    return words.contiguous(), (fail == 0).all(dim=1)


def pack_and_validate_u32(x: torch.Tensor, lengths: torch.Tensor,
                          pad_valid: bool = False):
    """Fused pack + validity mask (kernel A).  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    if x.dim() != 2 or x.shape[1] % 4:
        raise ValueError(
            f"pack input must be [N, W4] lanes with W4 a multiple of 4, "
            f"got {tuple(x.shape)} (pad the byte matrix to a multiple of "
            "16 columns)")
    if x.device.type == "cpu":
        return pack_and_validate_plain(x, lengths, pad_valid)
    _build.check_operand(x, "x", torch.int32, 2, x.device)
    _build.check_operand(lengths, "lengths", torch.int32, 1, x.device)
    n, w4 = x.shape
    if lengths.shape[0] != n:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, x has {n}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for vector loads")
    words = torch.empty((n, w4 // 4), dtype=torch.int32, device=x.device)
    ok = torch.empty(n, dtype=torch.bool, device=x.device)
    _build.launch("ssq_pack_validate", x.data_ptr(), lengths.data_ptr(),
                  words.data_ptr(), ok.data_ptr(), n, w4 // 4,
                  int(pad_valid))
    pack_and_validate_u32.launches += 1
    return words, ok


pack_and_validate_u32.launches = 0


def pack_and_validate_rows(mat_u32: np.ndarray, lengths: np.ndarray,
                           device, pad_valid: bool = False):
    """Host entry: numpy `[N, W4]` uint32 view + `[N]` lengths ->
    (`[N, W4 / 4]` int32 words, `[N]` bool ok) on `device`.  Replaces
    count/ingest.pack_validate_padded for the UMI slice: no batch padding
    (PyTorch compiles nothing per shape) and no row folding."""
    device = torch.device(device)
    x = from_numpy_u32(mat_u32).to(device)
    lens = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(device)
    return pack_and_validate_u32(x, lens, pad_valid=pad_valid)
