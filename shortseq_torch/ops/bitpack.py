"""2-bit pack + bloom validate (kernel A), pack only (kernel A's pack-only
mode), unpack to ASCII (kernel E), each beside its plain version, and the
per-row validity ops.

Counterpart of shortseq_tpu/ops/bitpack.py.  Input of the packs: `[N, W4]`
uint32 lanes (4 ASCII bytes per lane, little-endian), carried as int32,
and `[N]` int32 lengths.  Output: `[N, W4 / 4]` packed words (16 codes per
lane, LSB first, code = (c >> 1) & 3) and, when validating, an `[N]` bool
ok mask: a row is ok iff every byte before its length satisfies
(c & 63) in {1, 3, 7, 20}.  With `pad_valid` the length mask is skipped
(the caller promises the tail is PAD_BYTE).  Words of rows that are not
ok are unspecified, as in the JAX package.  The `_u32` functions take the
lanes; their u8 twins take `[N, L]` uint8 tensors with L % 4 == 0.

The JAX version's row folding and bf16 "poison" dot existed for the TPU's
128-lane tiles and its matrix unit; neither means anything on Hopper, so
kernel A is one read and one write (shortseq_torch/csrc/kernels.cu, note
A: bound by HBM bytes).  The folded names keep the JAX signatures: a
folded batch `[N/F, F*W4]` is a free row-major view of `[N, W4]`, so
`pack_and_validate_folded` and `pack_folded` are reshapes around kernel
A, and `fold_for` is the JAX arithmetic.  The JAX package's private
matrix helpers (`_compact_mats`, `_folded_mats`, `_pack_folded_raw`)
only build the TPU's dot operands and have no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..constants import CHARMAP_BYTES
from ..utils.profiling import scoped
from .lanes import from_numpy_u32, srl

# Fail bit (0x40 per byte) mask by the count of row bytes left in a lane.
_TAIL = (0, 0x40, 0x4040, 0x404040, 0x40404040)

# Low 32 bits of ~BLOOM: the pass set {1, 3, 7, 20} of (byte & 63); bit 5
# of a byte set always fails (constants.BLOOM).
_BLOOM_PASS_LO = 0x0010008A


def _u8_to_u32(ascii_u8: torch.Tensor) -> torch.Tensor:
    """`[N, 4k]` uint8 -> `[N, k]` int32 lanes, little-endian within each
    group of 4 bytes (a view of the same bytes)."""
    if ascii_u8.dim() != 2 or ascii_u8.shape[1] % 4:
        raise ValueError(f"byte matrix must be [N, L] with L a multiple of "
                         f"4, got {tuple(ascii_u8.shape)}")
    return ascii_u8.contiguous().view(torch.int32)


def _check_pack_input(x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] % 4:
        raise ValueError(
            f"pack input must be [N, W4] lanes with W4 a multiple of 4, "
            f"got {tuple(x.shape)} (pad the byte matrix to a multiple of "
            "16 columns)")


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


def pack_words_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel A's pack-only mode (any device)."""
    n, w4 = x.shape
    codes = _codes_byte(x).reshape(n, w4 // 4, 4)
    return (codes[..., 0] | (codes[..., 1] << 8) | (codes[..., 2] << 16)
            | (codes[..., 3] << 24)).contiguous()


def pack_and_validate_plain(x: torch.Tensor, lengths: torch.Tensor,
                            pad_valid: bool = False):
    """Plain PyTorch version of kernel A (any device)."""
    n, w4 = x.shape
    words = pack_words_plain(x)
    fail = _bloom_fail_bits(x)
    if not pad_valid:
        lane = torch.arange(w4, dtype=torch.int32, device=x.device)
        rem = (lengths.to(torch.int32)[:, None] - 4 * lane).clamp(0, 4)
        tail = torch.tensor(_TAIL, dtype=torch.int32, device=x.device)
        fail = fail & tail[rem.long()]
    return words, (fail == 0).all(dim=1)


def _check_lanes_operand(x: torch.Tensor) -> None:
    _build.check_operand(x, "x", torch.int32, 2, x.device)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned for vector loads")


@scoped("ssq.pack")
def pack_words_u32(x_u32: torch.Tensor) -> torch.Tensor:
    """Pack `[N, W4]` lanes (W4 % 4 == 0) to `[N, W4 / 4]` words with no
    validation (kernel A in its pack-only mode): every byte packs as
    (c >> 1) & 3, so zero padding packs to code 0, the reference's
    zero-filled tail.  A CUDA tensor launches the kernel; a CPU tensor
    takes the plain version."""
    _check_pack_input(x_u32)
    if x_u32.device.type == "cpu":
        return pack_words_plain(x_u32)
    _check_lanes_operand(x_u32)
    n, w4 = x_u32.shape
    words = torch.empty((n, w4 // 4), dtype=torch.int32,
                        device=x_u32.device)
    _build.launch("ssq_pack_validate", x_u32.data_ptr(), None,
                  words.data_ptr(), None, n, w4 // 4, 0)
    pack_words_u32.launches += 1
    return words


pack_words_u32.launches = 0


def pack_words(ascii_u8: torch.Tensor) -> torch.Tensor:
    """`[N, L]` uint8 ASCII (L % 16 == 0, zero padded) -> `[N, L / 16]`
    words, through pack_words_u32."""
    return pack_words_u32(_u8_to_u32(ascii_u8))


def pack_rows(mat_u32: np.ndarray, *, device="cuda") -> torch.Tensor:
    """Host entry for construction without validation: numpy `[N, W4]`
    uint32 view -> `[N, W4 / 4]` words on `device` (no row folding;
    "cuda" raises without a card)."""
    x = from_numpy_u32(mat_u32).to(torch.device(device))
    return pack_words_u32(x)


@scoped("ssq.pack_validate")
def pack_and_validate_u32(x_u32: torch.Tensor, lengths: torch.Tensor,
                          pad_valid: bool = False):
    """Fused pack + validity mask (kernel A).  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    _check_pack_input(x_u32)
    if x_u32.device.type == "cpu":
        return pack_and_validate_plain(x_u32, lengths, pad_valid)
    _check_lanes_operand(x_u32)
    _build.check_operand(lengths, "lengths", torch.int32, 1, x_u32.device)
    n, w4 = x_u32.shape
    if lengths.shape[0] != n:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, x has {n}")
    words = torch.empty((n, w4 // 4), dtype=torch.int32,
                        device=x_u32.device)
    ok = torch.empty(n, dtype=torch.bool, device=x_u32.device)
    _build.launch("ssq_pack_validate", x_u32.data_ptr(), lengths.data_ptr(),
                  words.data_ptr(), ok.data_ptr(), n, w4 // 4,
                  int(pad_valid))
    pack_and_validate_u32.launches += 1
    return words, ok


pack_and_validate_u32.launches = 0


def pack_and_validate_rows(mat_u32: np.ndarray, lengths: np.ndarray,
                           pad_valid: bool = False, *, device="cuda"):
    """Host entry: numpy `[N, W4]` uint32 view + `[N]` lengths ->
    (`[N, W4 / 4]` int32 words, `[N]` bool ok) on `device` ("cuda"
    raises without a card).  Replaces
    count/ingest.pack_validate_padded for the UMI slice: no batch padding
    (PyTorch compiles nothing per shape) and no row folding."""
    device = torch.device(device)
    x = from_numpy_u32(mat_u32).to(device)
    lens = torch.from_numpy(np.ascontiguousarray(lengths, np.int32)).to(device)
    return pack_and_validate_u32(x, lens, pad_valid=pad_valid)


def fold_for(w4: int, n: int, target_lanes: int = 128) -> int:
    """Row-fold factor for a `[n, w4]` batch, the JAX package's
    arithmetic: enough folded lanes to reach `target_lanes`, a power of
    two of at most 64 that divides n.  It sized the TPU's tiles; here it
    only names a layout, since every fold is the same bytes."""
    if w4 >= target_lanes or n <= 0:
        return 1
    fold = 1
    while fold * w4 < target_lanes and fold < 64:
        fold *= 2
    while fold > 1 and n % fold:
        fold //= 2
    return fold


def _unfold_rows(x_f: torch.Tensor, w4: int) -> torch.Tensor:
    """`[N/F, F*w4]` folded lanes -> the `[N, w4]` rows they hold."""
    if x_f.dim() != 2 or w4 <= 0 or x_f.shape[1] % w4:
        raise ValueError(f"folded lanes must be [N/F, F*{w4}], got "
                         f"{tuple(x_f.shape)}")
    return x_f.reshape(-1, w4)


def pack_and_validate_folded(x_f: torch.Tensor, lengths_f: torch.Tensor,
                             w4: int, unfold: bool = True,
                             pad_valid: bool = False):
    """Kernel A on a row-folded batch: `[N/F, F*w4]` lanes (F consecutive
    rows of `[N, w4]` in each) and `[N/F, F]` int32 lengths.  Returns
    `[N, w4/4]` words and `[N]` ok, or with unfold=False the folded
    layouts, `[N/F, F*w4/4]` words and `[N/F, F]` ok.  Both layouts are
    views of one launch's outputs."""
    nf = x_f.shape[0]
    words, ok = pack_and_validate_u32(_unfold_rows(x_f, w4),
                                      lengths_f.reshape(-1),
                                      pad_valid=pad_valid)
    if unfold:
        return words, ok
    return words.reshape(nf, -1), ok.reshape(nf, -1)


def pack_folded(x_f: torch.Tensor, w4: int, unfold: bool = True):
    """Kernel A's pack-only mode on a row-folded batch: `[N, w4/4]` words,
    or `[N/F, F*w4/4]` with unfold=False."""
    words = pack_words_u32(_unfold_rows(x_f, w4))
    return words if unfold else words.reshape(x_f.shape[0], -1)


def pack_and_validate(ascii_u8: torch.Tensor, lengths: torch.Tensor):
    """Fused pack + validity mask from a `[N, L]` uint8 matrix (kernel A,
    length-masked)."""
    return pack_and_validate_u32(_u8_to_u32(ascii_u8), lengths)


def validate_u32(x_u32: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-row validity: True iff every byte before the row's length passes
    the reference bloom filter (kernel A's ok, length-masked)."""
    return pack_and_validate_u32(x_u32, lengths)[1]


def validate(ascii_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """u8-matrix form of validate_u32."""
    return validate_u32(_u8_to_u32(ascii_u8), lengths)


def first_bad_byte_u32(x_u32: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Per-row index (int32) of the first bloom-failing byte before the
    row's length, or 4 * W4 if there is none.  Torch ops on any device: no
    path of the package reaches it (it exists for the reference's
    per-character error message)."""
    n, w4 = x_u32.shape
    big = 4 * w4
    lane = torch.arange(w4, dtype=torch.int32, device=x_u32.device)
    lengths = lengths.to(device=x_u32.device, dtype=torch.int32)[:, None]
    pass_lo = torch.tensor(_BLOOM_PASS_LO, dtype=torch.int32,
                           device=x_u32.device)
    first = torch.full((n,), big, dtype=torch.int32, device=x_u32.device)
    for k in range(4):
        c = (x_u32 >> (8 * k)) & 0xFF
        ok = (((pass_lo >> (c & 31)) & 1) == 1) & ((c & 32) == 0)
        pos = 4 * lane + k
        bad = ~ok & (pos[None, :] < lengths)
        first = torch.minimum(
            first, torch.where(bad, pos, big).min(dim=1).values)
    return first


def first_bad_byte(ascii_u8: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """u8-matrix form of first_bad_byte_u32."""
    return first_bad_byte_u32(_u8_to_u32(ascii_u8), lengths)


def collapse_xor(c: torch.Tensor) -> torch.Tensor:
    """((c >> 1) | c) & 0x55555555 on int32 lanes (logical shift): one bit
    a differing 2-bit field of c = a ^ b."""
    return (srl(c, 1) | c) & 0x55555555


def unpack_ascii_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel E (any device)."""
    n, w = words.shape
    shifts = torch.arange(0, 32, 2, dtype=torch.int32, device=words.device)
    codes = (words[:, :, None] >> shifts) & 3
    table = torch.tensor(CHARMAP_BYTES, dtype=torch.uint8,
                         device=words.device)
    return table[codes.long()].reshape(n, 16 * w)


@scoped("ssq.unpack")
def unpack_ascii(words: torch.Tensor, out_len: int | None = None):
    """Inverse of pack_words: `[N, W]` words -> `[N, 16 W]` uint8 ASCII
    (kernel E), the first `out_len` columns when given.  Codes decode
    through the reference charmap A, C, T, G; bases past a row's length
    decode to 'A' and are the caller's to slice off.  A CUDA tensor
    launches the kernel; a CPU tensor takes the plain version."""
    if words.dim() != 2:
        raise ValueError(f"words must be [N, W], got {tuple(words.shape)}")
    if words.device.type == "cpu":
        out = unpack_ascii_plain(words)
    else:
        _build.check_operand(words, "words", torch.int32, 2, words.device)
        n, w = words.shape
        out = torch.empty((n, 16 * w), dtype=torch.uint8, device=words.device)
        _build.launch("ssq_unpack_ascii", words.data_ptr(), out.data_ptr(),
                      n * w)
        unpack_ascii.launches += 1
    return out if out_len is None else out[:, :out_len]


unpack_ascii.launches = 0
