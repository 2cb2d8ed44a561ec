"""BGZF (bgzip) random access: byte-range sharding of compressed FASTQ.

Plain gzip streams have no random access, so multi-shard/multi-host runs
refuse them (io.fastq._read_range_synced).  BGZF - the blocked gzip
variant samtools/bgzip write, and what compressed genomics data actually
ships as - is a chain of independent <= 64 KiB gzip members, each
carrying its own compressed size (BSIZE) in a BC extra subfield
(SAM spec section 4.1).  That makes compressed byte ranges shardable:

  1. a shard [lo, hi) in COMPRESSED offsets maps to the blocks whose
     headers start in [lo, hi) (`first_block_at` - scan for the
     12-byte header + BC subfield, validated by chaining to the next
     header, so a false match inside compressed payload cannot occur
     without two consecutive forgeries);
  2. the shard's blocks decompress independently (each is a complete
     gzip member; one multi-member gzip.decompress per region);
  3. record boundaries are decided in DECOMPRESSED space with the exact
     same fastq_sync scan as plain files, seeded with the last byte of
     the preceding block so every shard reproduces the boundary a
     whole-file scan would compute.  Adjacent shards scan forward from
     the same decompressed position over the same bytes, so the
     partition is exact: every record lands in exactly one shard.

The reference cannot read compressed input at all (its reader is a plain
stdio getline loop, reference fast_read.pyx:3-20); the port's streamed
ingest needs it because it counts large files in byte-range slices
(io.fastq.read_fastq_index).  The port's copy of shortseq_tpu/io/bgzf.py:
pure host code.
"""

from __future__ import annotations

import gzip
import os

#: Scan window for locating block headers: strictly larger than the
#: largest legal BGZF block (BSIZE is a u16, so blocks are <= 65536
#: bytes) - any window of this size that starts inside a block contains
#: the next true header.
_WINDOW = 1 << 17

_MAGIC = b"\x1f\x8b\x08\x04"  # gzip + deflate + FEXTRA (BGZF requires it)


def _u16(buf: bytes, off: int) -> int:
    return buf[off] | (buf[off + 1] << 8)


def block_size_at(buf: bytes, off: int):
    """Total compressed size of the BGZF block whose header starts at
    `off` in `buf`, or None if no valid BGZF header starts there (magic +
    FEXTRA + a BC subfield with SLEN 2, per the SAM spec)."""
    if buf[off:off + 4] != _MAGIC or off + 12 > len(buf):
        return None
    xlen = _u16(buf, off + 10)
    p, end = off + 12, off + 12 + xlen
    if end > len(buf):
        return None
    while p + 4 <= end:
        slen = _u16(buf, p + 2)
        if buf[p] == 0x42 and buf[p + 1] == 0x43 and slen == 2:  # 'B','C'
            if p + 6 > end:
                return None
            return _u16(buf, p + 4) + 1
        p += 4 + slen
    return None


def is_bgzf(filename) -> bool:
    """True iff the file starts with a valid BGZF block header (bgzip
    output; detected by structure, not extension)."""
    with open(filename, "rb") as f:
        head = f.read(_WINDOW)
    return bool(head) and block_size_at(head, 0) is not None


def first_block_at(f, pos: int, fsize: int) -> int:
    """Absolute offset of the first BGZF block header at or after `pos`
    (fsize if none).  Candidates must parse as a header AND chain to
    either EOF or another parsing header - a match inside compressed
    payload would need two consecutive forged headers at consistent
    offsets."""
    if pos <= 0:
        return 0
    while pos < fsize:
        f.seek(pos)
        buf = f.read(min(_WINDOW + _WINDOW, fsize - pos))
        limit = min(len(buf), _WINDOW)
        i = 0
        while i < limit:
            j = buf.find(_MAGIC, i, limit)
            if j < 0:
                break
            bs = block_size_at(buf, j)
            if bs is not None:
                nxt = j + bs
                if pos + nxt == fsize or (
                        nxt + 18 <= len(buf)
                        and block_size_at(buf, nxt) is not None) or (
                        nxt + 18 > len(buf)
                        and _parses_at(f, pos + nxt, fsize)):
                    return pos + j
            i = j + 1
        pos += limit
    return fsize


def _parses_at(f, abs_off: int, fsize: int) -> bool:
    if abs_off >= fsize:
        return abs_off == fsize
    f.seek(abs_off)
    return block_size_at(f.read(_WINDOW), 0) is not None


def _prev_block(f, b_lo: int, fsize: int) -> int:
    """Start offset of the block ending exactly at b_lo (b_lo > 0).
    Found by hopping the BSIZE chain from the first header in the
    preceding window; the chain must land exactly on b_lo."""
    lo = max(0, b_lo - _WINDOW)
    cur = first_block_at(f, lo, fsize)
    while cur < b_lo:
        f.seek(cur)
        bs = block_size_at(f.read(_WINDOW), 0)
        if bs is None:
            break
        if cur + bs == b_lo:
            return cur
        cur += bs
    raise ValueError(
        "BGZF block chain is inconsistent (corrupt file?); decompress "
        "the file before multi-shard runs")


def _decompress(comp: bytes) -> bytes:
    """Decompress a run of complete BGZF blocks (multi-member gzip)."""
    return gzip.decompress(comp) if comp else b""


def read_range_synced(filename, lo: int, hi: int) -> bytes:
    """The decompressed bytes of exactly the FASTQ records whose first
    block starts in compressed range [lo, hi) - the BGZF analog of
    io.fastq._read_range_synced + fastq_sync, pre-synced (records are
    whole; no further boundary work needed).  IO and decompression are
    proportional to the shard, not the file."""
    from .fastq import fastq_sync

    if hi < lo:
        raise ValueError(f"inverted byte_range: lo {lo} > hi {hi}")
    fsize = os.path.getsize(filename)
    lo, hi = max(0, min(lo, fsize)), max(0, min(hi, fsize))
    with open(filename, "rb") as f:
        b_lo = first_block_at(f, lo, fsize)
        b_hi = first_block_at(f, max(hi, b_lo), fsize)
        # Seed byte for the record-sync scan: the last DECOMPRESSED byte
        # before this shard's blocks.  A spec-legal BGZF stream may
        # contain interior empty blocks (a writer flushing an empty
        # buffer, concatenated .bgz files with interior EOF markers), so
        # walk back block by block until one yields content; reaching the
        # file start with nothing decompressed means this shard begins at
        # decompressed offset 0 - a true record start.
        prefix = b""
        cur = b_lo
        while 0 < cur < fsize and not prefix:
            p = _prev_block(f, cur, fsize)
            f.seek(p)
            prev = _decompress(f.read(cur - p))
            prefix = prev[-1:]
            cur = p
        f.seek(b_lo)
        dec_own = _decompress(f.read(b_hi - b_lo))
        off0 = len(prefix)
        off_hi = off0 + len(dec_own)
        data = prefix + dec_own
        # Trailing margin: decompress forward blocks until the record
        # containing off_hi ends inside the buffer (records are ~2.5 KB;
        # one window of blocks nearly always suffices, but tiny blocks
        # could decompress to less, hence the loop).
        m_at = b_hi
        while b_hi < fsize:
            m_end = first_block_at(f, min(m_at + _WINDOW, fsize), fsize)
            f.seek(m_at)
            data += _decompress(f.read(m_end - m_at))
            m_at = m_end
            if m_end >= fsize or fastq_sync(data, off_hi) < len(data):
                break
    # An empty prefix after the walk-back means everything before b_lo
    # decompresses to nothing: the shard starts at decompressed offset 0,
    # which IS a record boundary (matching what the zero-record previous
    # shards concluded).
    s_lo = fastq_sync(data, off0) if prefix else 0
    s_hi = fastq_sync(data, off_hi) if b_hi < fsize else len(data)
    return data[s_lo:s_hi]
