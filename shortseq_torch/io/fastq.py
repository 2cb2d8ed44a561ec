"""FASTQ ingest for the UMI slice: the sequence line (2nd of every 4) of
each record as a PAD_BYTE-padded uint8 matrix, from
shortseq_tpu/io/fastq.py.  Whole-file reads only; ranged and BGZF reads
come with the pipeline slice.  Gzip input is detected by magic bytes and
decompressed transparently.
"""

from __future__ import annotations

import numpy as np

from ..constants import PAD_BYTE


def _is_gzip(filename) -> bool:
    with open(filename, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


def _read_bytes(filename) -> bytes:
    """Whole-file read, decompressing gzip (by magic bytes, not name)."""
    if _is_gzip(filename):
        import gzip

        with gzip.open(filename, "rb") as f:
            _advise_sequential(f)
            return f.read()
    with open(filename, "rb") as f:
        _advise_sequential(f)
        return f.read()


def _advise_sequential(f) -> None:
    """Kernel readahead hint for the sequential whole-file scan.
    Best-effort: not every platform or file object supports it."""
    try:
        import os

        os.posix_fadvise(f.fileno(), 0, 0, os.POSIX_FADV_SEQUENTIAL)
    except (AttributeError, OSError):
        pass


def fastq_line_index(buf: np.ndarray):
    """Return (starts, ends) byte offsets of every sequence line in a FASTQ
    buffer (newline excluded)."""
    nl = np.flatnonzero(buf == 10)
    if buf.size and (nl.size == 0 or nl[-1] != buf.size - 1):
        # tolerate a missing final newline
        nl = np.append(nl, buf.size)
    starts = np.empty_like(nl)
    starts[0] = 0
    starts[1:] = nl[:-1] + 1
    seq_starts = starts[1::4]
    seq_ends = nl[1::4]
    return seq_starts, seq_ends


def read_fastq_matrix(filename, pad_to: int = 16):
    """Parse a FASTQ file into a PAD_BYTE-padded `[N, L]` uint8 matrix
    plus `[N]` int32 lengths, L rounded up to a multiple of `pad_to`.

    Uses the native indexer (csrc/fastq_index.cpp) when built and falls
    back to the vectorized numpy parse."""
    from .native import fastq_matrix_native

    data = _read_bytes(filename)
    native = fastq_matrix_native(data, pad_to=pad_to)
    if native is not None:
        return native
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return (np.zeros((0, pad_to), dtype=np.uint8),
                np.zeros(0, dtype=np.int32))
    starts, ends = fastq_line_index(buf)
    lengths = (ends - starts).astype(np.int32)
    n = len(lengths)
    if n == 0:
        return np.zeros((0, pad_to), dtype=np.uint8), lengths
    max_len = int(lengths.max())
    width = max(pad_to, -(-max_len // pad_to) * pad_to)
    # Vectorized gather in row chunks of ~8 MB (bounded transient memory).
    mat = np.empty((n, width), dtype=np.uint8)
    chunk = max(1, (8 << 20) // max(width, 1))
    col = np.arange(width, dtype=np.int64)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        idx = starts[lo:hi, None] + col[None, :]
        keep = col[None, :] < lengths[lo:hi, None]
        np.take(buf, np.minimum(idx, buf.size - 1), out=mat[lo:hi])
        mat[lo:hi] *= keep
        mat[lo:hi] += np.uint8(PAD_BYTE) * ~keep
    return mat, lengths
