"""ShortSeqCounter and the FASTQ count pipeline, from
shortseq_tpu/api/counter.py.

ShortSeqCounter is the parity type of the reference counter (reference
counter.pyx:10-54): a dict subclass whose keys are restricted to ShortSeq
types.  The throughput path is not this object but the count engines
below, which read a FASTQ into a lazy CountTable and materialize the
dict only when asked:

* "host": the threaded native hash count (csrc ssq_host_count).
* "device": sort-unique-count on `device` (torch.sort + kernel D,
  count/device.py).  device="cuda" launches the kernels and raises when
  there is no card; device="cpu" runs their plain versions.
* "auto": "host" when the native library is built, else "device".

Every engine shares the ingest: native index (starts/lengths, no row
copy) -> fused host gather + 2-bit pack + bloom validate, and every
engine produces the same table contents.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import _build


def _backend():
    """The resolved object backend (native extension or pure Python)."""
    from .. import api

    return api


class ShortSeqCounter(dict):
    def __init__(self, source=None):
        super().__init__()
        if type(source) is list:
            self._count_py_bytes_list(source)

    def __setitem__(self, key, val):
        # Key-type restriction (reference counter.pyx:17-19)
        b = _backend()
        if type(key) not in (b.ShortSeq64, b.ShortSeq192, b.ShortSeqVar):
            raise TypeError(
                f"{self.__class__} does not support {type(key)} keys")
        dict.__setitem__(self, key, val)

    def _count_py_bytes_list(self, it):
        # C-speed ingest loop when the native extension is built
        # (reference counter.pyx:22-29's role).
        native = _build.load_objects()
        if native is not None:
            native.count_bytes_list(self, it)
            return
        from_bytes = _backend().from_bytes
        get = self.get
        setter = dict.__setitem__
        for seqbytes in it:
            s = from_bytes(seqbytes)
            setter(self, s, get(s, 0) + 1)

    def count_sequences(self, seqs):
        """Ingest an iterable of already-packed ShortSeq objects."""
        get = self.get
        setter = dict.__setitem__
        for s in seqs:
            setter(self, s, get(s, 0) + 1)

    def update_counts(self, pairs):
        """Merge (ShortSeq, count) pairs."""
        get = self.get
        setter = dict.__setitem__
        for s, c in pairs:
            setter(self, s, get(s, 0) + c)


def update_counter_from_host_table(counter, words, lengths, counts) -> None:
    """Add a host count table (words `[M, W]` uint32, lengths `[M]` int32,
    counts `[M]` int32/int64) into `counter` - one native call for the
    whole table when the extension is built, a Python loop otherwise."""
    counts = np.asarray(counts)
    # Counts must be signed integers BEFORE the negative check: the native
    # table view reinterprets the buffer bitwise.  Unsigned widens exactly.
    if not np.issubdtype(counts.dtype, np.integer):
        raise TypeError(f"counts must be an integer array, got {counts.dtype}")
    if np.issubdtype(counts.dtype, np.unsignedinteger):
        counts = counts.astype(np.int64)
    # Poisoned (-1) counts must fail loudly, on every backend.
    if counts.size and int(counts.min()) < 0:
        raise OverflowError(
            "count table entry exceeded int32; merge in smaller pieces")
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lengths64 = np.asarray(lengths, dtype=np.int64)
    # A length beyond the table's lane capacity would materialize keys
    # with fabricated 'A' tail bases (truncated/width-mismatched table).
    if lengths64.size and (int(lengths64.min()) < 0
                           or int(lengths64.max()) > 16 * words.shape[1]):
        raise ValueError(
            f"table row length out of range for {words.shape[1]} lanes "
            f"(lengths span [{lengths64.min()}, {lengths64.max()}], "
            f"capacity {16 * words.shape[1]} nt)")
    native = _build.load_objects()
    if native is not None:
        native.update_from_table(
            counter, words,
            np.ascontiguousarray(lengths64, dtype=np.int32),
            np.ascontiguousarray(counts))
        return
    from ..count.device import _rows_to_table

    b = _backend()
    setter = dict.__setitem__
    for (length, blocks), count in _rows_to_table(words, lengths, counts):
        key = b.from_blocks(blocks, length)
        setter(counter, key, counter.get(key, 0) + count)


def table_to_counter(table) -> ShortSeqCounter:
    """One device count table (words, lengths, counts, n_unique) ->
    reference-identical ShortSeqCounter.  Goes through
    count/device.table_to_host, so an n_out overflow and a poisoned count
    raise instead of dropping or corrupting keys (the single-table case of
    shortseq_tpu/dist/pipeline.py table_to_counter)."""
    from ..count.device import table_to_host

    out = ShortSeqCounter()
    update_counter_from_host_table(out, *table_to_host(table))
    return out


def count_matrix_device(mat, lengths, device="cuda") -> ShortSeqCounter:
    """Count a padded ASCII read matrix on `device` and materialize a
    reference-identical ShortSeqCounter.

    Reads are bucketed by width class (<=32, <=96, <=1024 nt - the
    reference's ladder) and each bucket is packed and validated on the
    device (kernel A) and counted there (torch.sort + kernel D); bucket
    tables are disjoint by length, so the final dict is their union.
    Raises the reference's error on invalid bases."""
    from ..constants import MAX_VAR_NT, TOO_LONG_MSG, UNSUPPORTED_BASE_MSG
    from ..count.device import count_batch, fetch_table
    from ..count.ingest import WIDTH_EDGES, bucket_mask
    from ..oracle import first_invalid_char
    from ..ops.bitpack import pack_and_validate_rows

    counts = ShortSeqCounter()
    if len(lengths) == 0:
        return counts
    if int(np.max(lengths)) > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)
    device = _build.resolve_device(device)
    for lo, hi, width in WIDTH_EDGES:
        sel = bucket_mask(lengths, lo, hi)
        if not sel.any():
            continue
        rows = np.ascontiguousarray(mat[sel][:, :width]) \
            if mat.shape[1] >= width \
            else np.pad(mat[sel], ((0, 0), (0, width - mat.shape[1])))
        sub_len = lengths[sel].astype(np.int32)
        words, ok = pack_and_validate_rows(rows.view(np.uint32), sub_len,
                                           device)
        ok = ok.cpu().numpy()
        if not ok.all():
            bad_idx = int(np.argmin(ok))
            bad = first_invalid_char(rows[bad_idx][:int(sub_len[bad_idx])])
            raise Exception(f"{UNSUPPORTED_BASE_MSG}: {bad}")
        table = count_batch(words, torch.from_numpy(sub_len).to(device))
        u_w, u_l, u_c, _ = fetch_table(*table)
        update_counter_from_host_table(counts, u_w, u_l, u_c)
    return counts


#: Buckets of at least this many rows go to the device in 4 chunks, each
#: counted on its own, and the chunk tables merge in one weighted
#: unique_count; smaller buckets take one transfer and one count.
#: Override (0 disables chunking) with SHORTSEQ_TORCH_H2D_CHUNK_ROWS.
H2D_CHUNK_MIN_ROWS = 1 << 21

#: Largest live length of the int16 lengths wire format (_put_lengths).
_MAX_WIRE_LENGTH = 2**15 - 1


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _h2d_chunks(rows: int) -> int:
    min_rows = _env_int("SHORTSEQ_TORCH_H2D_CHUNK_ROWS", H2D_CHUNK_MIN_ROWS)
    if min_rows <= 0 or rows < max(min_rows, 4):
        return 1
    return 4


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """Host tensor -> `device`: through pinned memory with a non-blocking
    copy on CUDA (the pinned buffer is held by PyTorch's host allocator
    until the copy has run)."""
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _put_words(words: np.ndarray, device: torch.device) -> torch.Tensor:
    from ..ops.lanes import from_numpy_u32

    return _to_device(from_numpy_u32(words), device)


def _put_lengths(sub_len, device: torch.device) -> torch.Tensor:
    """Ship per-row lengths to the device as int16 and widen there:
    lengths are <= 1024 and PAD_LENGTH maps to -1, so the int16 wire
    format halves the lengths' share of the transfer.  Raises if a live
    length does not fit the wire format."""
    from ..count.device import PAD_LENGTH

    sub_len = np.asarray(sub_len)
    live = sub_len != PAD_LENGTH
    if live.any() and int(sub_len[live].max()) > _MAX_WIRE_LENGTH:
        raise ValueError(
            f"read length {int(sub_len[live].max())} does not fit the "
            f"int16 lengths wire format (max {_MAX_WIRE_LENGTH})")
    l16 = np.where(live, sub_len, -1).astype(np.int16)
    lens = _to_device(torch.from_numpy(l16), device).to(torch.int32)
    return torch.where(lens < 0, PAD_LENGTH, lens)


def count_indexed_device_table(data, starts, lengths, device="cuda"):
    """Count indexed FASTQ rows (io.fastq.read_fastq_index output) on
    `device`: host gather+pack per width bucket, device sort-unique-count.
    Returns a lazy count.table.CountTable whose buckets stay on the
    device - `most_common(n)` / lookups fetch O(n) rows, never the whole
    table.  Bucket tables are disjoint by length, so the logical table is
    their union.

    A bucket of at least H2D_CHUNK_MIN_ROWS rows goes over in 4 chunks,
    each counted as it lands, and the 4 chunk tables merge in one
    unique_count with their counts as weights."""
    from ..count.device import unique_count
    from ..count.ingest import packed_buckets
    from ..count.table import CountTable

    device = _build.resolve_device(device)
    if len(lengths) == 0:
        return CountTable([])
    tables = []
    for words, sub_len in packed_buckets(data, starts, lengths):
        rows = len(sub_len)
        n_chunks = _h2d_chunks(rows)
        bounds = [rows * i // n_chunks for i in range(n_chunks + 1)]
        chunk_tables = []
        for lo, hi in zip(bounds, bounds[1:]):
            chunk_tables.append(unique_count(
                _put_words(words[lo:hi], device),
                _put_lengths(sub_len[lo:hi], device),
                torch.ones(hi - lo, dtype=torch.int32, device=device)))
        if n_chunks == 1:
            tables.append(chunk_tables[0])
        else:
            tables.append(unique_count(
                *(torch.cat([t[i] for t in chunk_tables]) for i in range(3))))
    return CountTable.from_device_tables(tables)


def count_indexed_device(data, starts, lengths,
                         device="cuda") -> ShortSeqCounter:
    """Eager form of count_indexed_device_table: materializes the full
    reference-identical dict.  The JAX package's `batch_size` argument is
    left out: there it only set how finely the host gathered before the
    one transfer per bucket (the sharded pipeline's device batches take
    PipelineConfig.batch_size instead)."""
    return count_indexed_device_table(data, starts, lengths,
                                      device=device).to_counter()


def count_indexed_host_table(data, starts, lengths):
    """Count indexed FASTQ rows entirely on the host: fused native gather +
    2-bit pack + bloom validate, threaded partitioned hash count (csrc
    ssq_host_count).  Returns a lazy CountTable over the compact host
    arrays, or None when the native library is unavailable."""
    from ..count.ingest import packed_buckets
    from ..count.table import CountTable
    from ..io.native import get_lib, host_count_native

    if get_lib() is None:
        return None  # decide BEFORE packing
    if len(lengths) == 0:
        return CountTable([])
    return CountTable.from_host_tables(
        host_count_native(words, sub_len)
        for words, sub_len in packed_buckets(data, starts, lengths))


def count_indexed_host(data, starts, lengths) -> ShortSeqCounter | None:
    """Eager form of count_indexed_host_table (the same table contents as
    the device engine), or None when the native library is unavailable."""
    table = count_indexed_host_table(data, starts, lengths)
    return None if table is None else table.to_counter()


def read_and_count_fastq(filename, engine: str = "auto",
                         device="cuda") -> ShortSeqCounter:
    """End-to-end FASTQ dedup pipeline with the reference's phase-timing
    print (reference counter.pyx:57-71).  See the module docstring for the
    engines; `device` is where the "device" engine counts."""
    from ..utils.profiling import PhaseTimings, phase_timer

    timings = PhaseTimings()
    with phase_timer("total", timings):
        table, n_reads = _read_and_count_table(filename, engine, device)
        counts = table.to_counter()
    timings.add("read", table._read_seconds)
    timings.add("count", timings.phases["total"] - table._read_seconds)
    print(f"{timings.phases['read']:.2f}s to read {n_reads} total seqs, "
          f"and {timings.phases['count']:.2f}s to count "
          f"{len(counts)} unique sequences")
    return counts


#: Files larger than this count in byte-range slices instead of one
#: whole-file read, bounding host memory at O(slice + unique table).
#: Override with the SHORTSEQ_TORCH_STREAM_BYTES env var (also the slice
#: size).
DEFAULT_STREAM_BYTES = 1 << 30


def _stream_bytes() -> int:
    return _env_int("SHORTSEQ_TORCH_STREAM_BYTES", DEFAULT_STREAM_BYTES)


def _read_and_count_table(filename, engine: str, device):
    """Shared engine policy: index the FASTQ, count with the requested
    engine, return (CountTable, n_reads).  The read-phase seconds are
    stashed on the table for the reference-style timing print.

    Files above the streaming threshold count in byte-range slices
    (record-synced boundaries); plain gzip streams have no random access
    and keep the whole-file path, while BGZF files stream block-aligned
    slices (io/bgzf.py)."""
    from ..io.fastq import _is_gzip, read_fastq_index

    if engine not in ("auto", "host", "device"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "device":
        device = _build.resolve_device(device)  # before any host work
    try:
        size = os.path.getsize(filename)
    except OSError:
        size = 0
    stream_bytes = _stream_bytes()

    def _range_shardable() -> bool:
        if not _is_gzip(filename):
            return True
        from ..io.bgzf import is_bgzf

        return is_bgzf(filename)

    if size > stream_bytes and _range_shardable():
        return _read_and_count_table_streamed(filename, engine, size,
                                              stream_bytes, device)
    t1 = time.time()
    data, starts, lengths = read_fastq_index(filename)
    t2 = time.time()
    table = None
    if engine in ("auto", "host"):
        table = count_indexed_host_table(data, starts, lengths)
        if table is None and engine == "host":
            raise RuntimeError(
                "engine='host' requires the native library (g++)")
    if table is None:
        table = count_indexed_device_table(data, starts, lengths,
                                           device=device)
    table._read_seconds = t2 - t1
    return table, len(lengths)


def _read_and_count_table_streamed(filename, engine: str, size: int,
                                   stream_bytes: int, device):
    """Bounded-memory ingest: index+gather+count one byte-range slice at
    a time (record-synced boundaries, io.fastq.fastq_sync), keep only each
    slice's compact unique table, and merge once at the end.

    Host engine: per-slice native hash counts, merged with ONE weighted
    native count over the concatenated unique rows (csrc
    ssq_host_count_w).  Device engine: per-slice device tables fetched to
    compact host tuples, merged with one unique_count per width on
    `device` (count/checkpoint.merge_host_tuples)."""
    from ..count.ingest import packed_buckets
    from ..count.table import CountTable
    from ..io.fastq import read_fastq_index
    from ..io.native import get_lib, host_count_native, \
        host_count_weighted_native

    use_host = engine in ("auto", "host") and get_lib() is not None
    if engine == "host" and get_lib() is None:
        raise RuntimeError("engine='host' requires the native library (g++)")
    n_slices = -(-size // stream_bytes)
    by_width: dict[int, list] = {}
    t_read = 0.0
    n_reads = 0
    for s in range(n_slices):
        lo = s * size // n_slices
        hi = (s + 1) * size // n_slices
        t0 = time.time()
        data, starts, lengths = read_fastq_index(filename,
                                                 byte_range=(lo, hi))
        t_read += time.time() - t0
        n_reads += len(lengths)
        if len(lengths) == 0:
            continue
        if use_host:
            for words, sub_len in packed_buckets(data, starts, lengths):
                by_width.setdefault(words.shape[1], []).append(
                    host_count_native(words, sub_len))
        else:
            from ..count.device import table_to_host

            t = count_indexed_device_table(data, starts, lengths,
                                           device=device)
            for b in t._buckets:
                by_width.setdefault(b.width, []).append(table_to_host(
                    (b.words, b.lengths, b.counts, b._n)))
        del data, starts, lengths  # one slice buffer at a time
    if use_host:
        tables = []
        for width, parts in sorted(by_width.items()):
            if len(parts) == 1:
                tables.append(parts[0])
                continue
            w = np.concatenate([p[0] for p in parts])
            lens = np.concatenate([p[1] for p in parts])
            c = np.concatenate([p[2] for p in parts]).astype(np.int64)
            tables.append(host_count_weighted_native(w, lens, c))
        table = CountTable.from_host_tables(tables)
    else:
        from ..count.checkpoint import merge_host_tuples

        table = CountTable.from_device_tables(
            [merge_host_tuples(parts, device=device)
             for _, parts in sorted(by_width.items())])
    table._read_seconds = t_read
    return table, n_reads


def read_and_count_fastq_table(filename, engine: str = "auto",
                               device="cuda"):
    """Lazy form of read_and_count_fastq: returns a count.table.CountTable
    instead of a materialized dict, so partial consumers (`--top N`,
    len/total, membership probes) never pay for constructing millions of
    Python objects.  Same engine policy and identical logical contents;
    call .to_counter() for the reference-identical dict."""
    from ..utils.profiling import PhaseTimings, phase_timer

    timings = PhaseTimings()
    with phase_timer("total", timings):
        table, n_reads = _read_and_count_table(filename, engine, device)
        n_unique = len(table)  # forces the device n_unique fetch: honest
    timings.add("read", table._read_seconds)
    timings.add("count", timings.phases["total"] - table._read_seconds)
    print(f"{timings.phases['read']:.2f}s to read {n_reads} total seqs, "
          f"and {timings.phases['count']:.2f}s to count "
          f"{n_unique} unique sequences")
    return table
