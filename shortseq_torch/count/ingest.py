"""Host-side ingest: indexed FASTQ rows -> packed-word buckets, from
shortseq_tpu/count/ingest.py.

2-bit packing and bloom validation happen during the host gather
(io.fastq.gather_pack), so the device receives packed lanes: 4x less
host->device traffic than ASCII rows, and no separate device validation
pass.  Buckets follow the reference's width ladder (short_seq.pyx:54-74):
<=32 nt -> 2 lanes, <=96 -> 6, <=1024 -> 64.

The batch padding keeps the JAX package's meaning and defaults
(`packed_buckets(pad_pow2=...)`, `quarter_pow2`, `pack_validate_padded`):
there it kept the set of XLA compile shapes closed.  The port compiles
nothing per shape, so its own callers pass pad_pow2=False and send no
pad rows.
"""

from __future__ import annotations

import numpy as np

from ..constants import MAX_64_NT, MAX_192_NT, MAX_VAR_NT, TOO_LONG_MSG

WIDTH_EDGES = [(0, MAX_64_NT, 32), (MAX_64_NT, MAX_192_NT, 96),
               (MAX_192_NT, MAX_VAR_NT, 1024)]


def quarter_pow2(n: int, floor: int = 256) -> int:
    """Round up to the next quarter-power-of-two step (2^k, 1.25*2^k,
    1.5*2^k, 1.75*2^k), at least `floor`: at most 25% pad rows, against
    up to 100% for plain powers of two."""
    n = max(n, 1)
    if n <= floor:
        return floor
    base = 1 << (n - 1).bit_length() - 1  # largest pow2 < padded result
    for num in (5, 6, 7):
        cand = base * num // 4
        if cand >= n:
            return cand
    return base * 2


def pack_validate_padded(rows: np.ndarray, val_lengths: np.ndarray,
                         min_pad: int = 256, pad_valid: bool = False,
                         device="cuda"):
    """Kernel A on a host byte matrix `[N, width]` (width % 16 == 0) with
    its row count padded to quarter_pow2(N, min_pad) by PAD_BYTE rows of
    validation length 0 (vacuously valid, and they pack to zero words,
    so the padded batch keeps the pad_valid contract).

    pad_valid: pass True only when the tail bytes of `rows` are PAD_BYTE,
    as the package's matrix readers write them (ops.bitpack).

    Returns (words `[N_pad, width // 16]` int32 on `device`, ok `[N]`
    host bool): the words keep the padded rows, ok is cut back to the
    caller's N.  Rows with ok False have unspecified words."""
    from .. import _build
    from ..constants import PAD_BYTE
    from ..ops.bitpack import pack_and_validate_rows

    device = _build.resolve_device(device)
    n, width = rows.shape
    if width % 16:
        raise ValueError(f"row width {width} is not a multiple of 16")
    val_lengths = np.ascontiguousarray(val_lengths, np.int32)
    n_pad = quarter_pow2(n, floor=min_pad)
    if n_pad != n:
        rows = np.pad(rows, ((0, n_pad - n), (0, 0)),
                      constant_values=PAD_BYTE)
        val_lengths = np.pad(val_lengths, (0, n_pad - n))
    words, ok = pack_and_validate_rows(
        np.ascontiguousarray(rows).view(np.uint32), val_lengths,
        pad_valid=pad_valid, device=device)
    return words, ok.cpu().numpy()[:n]


def bucket_mask(lengths: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Rows of the width bucket (lo, hi]; empty reads join the first."""
    sel = (lengths > lo) & (lengths <= hi)
    if lo == 0:
        sel |= lengths == 0
    return sel


def packed_buckets(data, starts, lengths, batch_size: int | None = None,
                   min_pad: int = 256, pad_pow2: bool | str = True):
    """Yield (words uint32 [M, width//16], sub_len int32 [M]) per width
    bucket, host-packed and host-validated: at most `batch_size` unpadded
    rows per yield, or one batch per bucket when it is None.  Each
    yield's rows pad to a power of two (>= min_pad) with zero words of
    length PAD_LENGTH, which unique_count drops; pad_pow2="quarter" pads
    to quarter_pow2 steps instead, and pad_pow2=False not at all (the
    port's own callers).

    Raises the reference's errors: "Unsupported base character: X" on an
    invalid byte, TOO_LONG_MSG past 1024 nt.

    Counts the bytes of the lanes it yields on packed_buckets.lane_bytes.
    """
    from ..count.device import PAD_LENGTH
    from ..io.fastq import gather_pack
    from ..utils.profiling import named_scope

    if isinstance(pad_pow2, str) and pad_pow2 != "quarter":
        raise ValueError(f"unknown pad_pow2 mode {pad_pow2!r}")
    lengths = np.asarray(lengths)
    if len(lengths) and int(lengths.max()) > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)
    starts = np.asarray(starts)
    for lo, hi, width in WIDTH_EDGES:
        sel = bucket_mask(lengths, lo, hi)
        n_sel = int(np.count_nonzero(sel))
        if n_sel == 0:
            continue
        if n_sel == len(lengths):  # single-bucket file: skip the gather
            s_sel, len_sel = starts, lengths.astype(np.int32, copy=False)
        else:
            s_sel = starts[sel]
            len_sel = lengths[sel].astype(np.int32)
        bs = batch_size or len(len_sel)
        for off in range(0, len(len_sel), bs):
            sub_len = len_sel[off:off + bs]
            with named_scope("ssq.gather_pack"):
                words = gather_pack(data, s_sel[off:off + bs], sub_len,
                                    width)
            m = len(sub_len)
            if pad_pow2 == "quarter":
                m_pad = quarter_pow2(m, floor=min_pad)
            elif pad_pow2:
                m_pad = max(min_pad, 1 << (m - 1).bit_length())
            else:
                m_pad = m
            if m_pad != m:
                words = np.pad(words, ((0, m_pad - m), (0, 0)))
                sub_len = np.pad(sub_len, (0, m_pad - m),
                                 constant_values=PAD_LENGTH)
            packed_buckets.lane_bytes += words.nbytes
            yield words, sub_len


packed_buckets.lane_bytes = 0
