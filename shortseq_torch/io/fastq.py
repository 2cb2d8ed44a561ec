"""FASTQ ingest: the sequence line (2nd of every 4) of each record, from
shortseq_tpu/io/fastq.py.

Three consumers:
  * read_fastq_lines / read_fastq_seqs -> the sequence lines as bytes or
    as ShortSeq objects (the reference's fast_read.pyx surface).
  * read_fastq_index + gather_pack -> packed uint32 lanes straight from
    the file buffer (the count path: fused native gather + 2-bit pack +
    bloom validate, count/ingest.packed_buckets).  `byte_range` reads
    one record-synced slice of a plain or BGZF file (the streamed count).
  * read_fastq_matrix -> PAD_BYTE-padded uint8 matrix + lengths, for
    reads that go to the device as ASCII (UMI dedup, count_matrix_device).

Gzip input is detected by magic bytes and decompressed transparently.
Plain gzip allows whole-file reads only; BGZF (bgzip) files also read by
byte range, on block boundaries (io/bgzf.py).
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


# Longest FASTQ record we expect to straddle a slice boundary: header +
# 1024 nt seq + separator + 1024 qual, with slack for long headers.
_SYNC_MARGIN = 1 << 20


_GZIP_SHARD_MSG = (
    "byte-range sharding needs random access; plain gzip streams have "
    "none. Recompress with bgzip (BGZF blocks ARE shardable here) or "
    "decompress once before multi-shard/multi-host runs.")


def _bgzf_range_or_raise(filename, lo: int, hi: int) -> bytes:
    """Gzip-input routing of the ranged reader: BGZF files return the
    slice's pre-synced whole records (io.bgzf), plain gzip raises."""
    from .bgzf import is_bgzf, read_range_synced

    if not is_bgzf(filename):
        raise ValueError(_GZIP_SHARD_MSG)
    return read_range_synced(filename, lo, hi)


def _read_range_synced(filename, lo: int, hi: int):
    """Read only the bytes needed for the records starting in [lo, hi):
    [lo-1, hi + margin).  Returns (buffer, base) where sync offsets
    relative to the buffer are absolute - base.

    The extra leading byte lets the record-sync scan see the newline just
    before `lo`, so every slice computes the exact same boundary as a
    full-file scan would; the trailing margin bounds how far past `hi` the
    first record start may be."""
    import os

    if _is_gzip(filename):
        raise ValueError(_GZIP_SHARD_MSG)
    if hi < lo:
        # An inverted range would make f.read(read_hi - base) negative,
        # i.e. read-to-EOF: the whole file tail instead of an error.
        raise ValueError(f"inverted byte_range: lo {lo} > hi {hi}")
    size = os.path.getsize(filename)
    lo = max(0, min(lo, size))
    base = max(0, lo - 1)
    read_hi = min(size, max(hi, lo) + _SYNC_MARGIN)
    with open(filename, "rb") as f:
        _advise_sequential(f)
        f.seek(base)
        return f.read(read_hi - base), base


def fastq_sync(data: bytes, offset: int) -> int:
    """First FASTQ record boundary at or after `offset`: a line start whose
    line begins '@' and where the line two lines later begins '+'.

    Pure-Python twin of the native ssq_fastq_sync (csrc/fastq_index.cpp):
    byte-for-byte the same boundary decisions.  Quality lines may legally
    start with '@'; the look-two-ahead check rejects those, because two
    lines after a quality line is a sequence line, never '+'.
    """
    n = len(data)
    if offset <= 0:
        return 0
    p = data.find(b"\n", max(offset - 1, 0))
    while p != -1:
        ls = p + 1
        if ls >= n:
            return n
        if data[ls] == 0x40:  # '@'
            nl1 = data.find(b"\n", ls)
            if nl1 == -1:
                return n
            nl2 = data.find(b"\n", nl1 + 1)
            if nl2 == -1:
                return n
            if nl2 + 1 < n and data[nl2 + 1] == 0x2B:  # '+'
                return ls
        p = data.find(b"\n", ls)
    return n


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


def read_fastq_lines(filename):
    """Sequence lines as a list of bytes (newline stripped)."""
    data = _read_bytes(filename)
    if not data:
        return []
    return data.split(b"\n")[1::4]


def read_fastq_seqs(filename):
    """Sequence lines packed into ShortSeq objects, like the reference's
    _read_fastq_short_seqs (fast_read.pyx:3-20)."""
    from ..api import from_bytes

    return [from_bytes(line) for line in read_fastq_lines(filename)]


def _read_for_range(filename, byte_range):
    """The bytes to parse for byte_range=(lo, hi) (None: the whole file)
    and the range left to sync inside them: a plain file's slice plus its
    sync margin, with (lo, hi) relative to it; a BGZF file's blocks,
    already synced to whole records (range None)."""
    if byte_range is None:
        return _read_bytes(filename), None
    lo, hi = byte_range
    if _is_gzip(filename):
        return _bgzf_range_or_raise(filename, lo, hi), None
    data, base = _read_range_synced(filename, lo, hi)
    return data, (lo - base, hi - base)


def read_fastq_matrix(filename, pad_to: int = 16, byte_range=None):
    """Parse a FASTQ file into a PAD_BYTE-padded `[N, L]` uint8 matrix
    plus `[N]` int32 lengths, L rounded up to a multiple of `pad_to`.

    Uses the native indexer (csrc/fastq_index.cpp) when built and falls
    back to the vectorized numpy parse.  `byte_range=(lo, hi)` restricts
    parsing to the records starting inside the range, reading only that
    slice (+ sync margin) of a plain file, or its blocks of a BGZF file."""
    from .native import fastq_matrix_native

    data, rng = _read_for_range(filename, byte_range)
    native = fastq_matrix_native(data, pad_to=pad_to, byte_range=rng)
    if native is not None:
        return native
    if rng is not None:
        # fastq_sync is the native sharder's byte-for-byte twin.
        data = data[fastq_sync(data, rng[0]):fastq_sync(data, rng[1])]
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


def read_fastq_index(filename, byte_range=None):
    """Index a FASTQ file without gathering: (buffer bytes, starts int64,
    lengths int32) of every sequence line, ready for gather_pack.  Uses the
    native indexer when built; numpy otherwise.  byte_range restricts to
    records starting inside [lo, hi), reading only that slice (+ sync
    margin) from disk."""
    from .native import fastq_index_native

    data, rng = _read_for_range(filename, byte_range)
    native = fastq_index_native(data, rng)
    if native is not None:
        return native
    if rng is not None:
        s_lo = fastq_sync(data, rng[0])
        s_hi = fastq_sync(data, rng[1])
        data = data[s_lo:s_hi]
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        return data, np.zeros(0, np.int64), np.zeros(0, np.int32)
    starts, ends = fastq_line_index(buf)
    return data, starts.astype(np.int64), (ends - starts).astype(np.int32)


def gather_pack(data: bytes, starts, lengths, width: int):
    """Gather + 2-bit pack indexed rows from the file buffer into
    [N, width//16] uint32 packed lanes (reference bit layout), validating
    every byte with the reference's exact bloom semantics.  Rows longer
    than `width` are truncated (callers bucket by width first).  Native
    single pass when built; the vectorized numpy twin below otherwise,
    with bit-identical outputs."""
    from .native import gather_pack_native

    native = gather_pack_native(data, starts, lengths, width)
    if native is not None:
        return native
    return gather_pack_numpy(data, starts, lengths, width)


def gather_pack_numpy(data: bytes, starts, lengths, width: int):
    """The numpy twin of gather_pack_native."""
    from ..constants import UNSUPPORTED_BASE_MSG
    from ..oracle import first_invalid_char

    assert width % 16 == 0
    buf = np.frombuffer(data, dtype=np.uint8)
    starts = np.asarray(starts, dtype=np.int64)
    n = len(starts)
    words = np.empty((n, width // 16), dtype=np.uint32)
    col = np.arange(width, dtype=np.int64)
    shift = (2 * (np.arange(width, dtype=np.uint32) % 16))
    chunk = max(1, (8 << 20) // max(width, 1))   # ~8 MB of rows per chunk
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        lens = np.minimum(lengths[lo:hi], width)
        idx = starts[lo:hi, None] + col[None, :]
        keep = col[None, :] < lens[:, None]
        sub = buf[np.minimum(idx, buf.size - 1)] * keep
        v = sub & 63
        # Bloom pass set {1, 3, 7, 20} of (c & 63); zeroed out-of-range
        # bytes are vacuously ok.
        ok = (v == 1) | (v == 3) | (v == 7) | (v == 20) | ~keep
        if not ok.all():
            r = int(np.argmin(ok.all(axis=1)))
            row = bytes(buf[starts[lo + r]:starts[lo + r] + int(lens[r])])
            raise Exception(
                f"{UNSUPPORTED_BASE_MSG}: {first_invalid_char(row)}")
        codes = ((sub.astype(np.uint32) >> 1) & 3) << shift
        words[lo:hi] = np.bitwise_or.reduce(
            codes.reshape(hi - lo, width // 16, 16), axis=2)
    return words
