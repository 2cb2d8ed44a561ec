"""ctypes bindings of the native host library (csrc/fastq_index.cpp), from
shortseq_tpu/io/native.py.

The library is built by shortseq_torch/_build.py at first use.  Host
code keeps the JAX package's behaviour when it is missing (or when
SHORTSEQ_TORCH_FORCE_PYTHON=1): every function here returns None, and the
callers take their pure-Python paths.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .. import _build

_lock = threading.Lock()
_lib = None
_bound = False


def get_lib():
    """The host library with argtypes set, or None when unavailable."""
    global _lib, _bound
    with _lock:
        if not _bound:
            _bound = True
            if _build.force_python():
                return None
            path = _build.build_host()
            if path is not None:
                _lib = ctypes.CDLL(str(path))
                _bind(_lib)
        return _lib


def _bind(lib) -> None:
    c_char_p = ctypes.c_char_p
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_u32 = ctypes.POINTER(ctypes.c_uint32)
    lib.ssq_count_lines.restype = i64
    lib.ssq_count_lines.argtypes = [c_char_p, i64]
    lib.ssq_fastq_index.restype = i64
    lib.ssq_fastq_index.argtypes = [c_char_p, i64, p_i64, p_i32, i64]
    lib.ssq_gather_padded.restype = None
    lib.ssq_gather_padded.argtypes = [c_char_p, p_i64, p_i32, i64, i64, p_u8]
    lib.ssq_max_length.restype = i32
    lib.ssq_max_length.argtypes = [p_i32, i64]
    lib.ssq_fastq_sync.restype = i64
    lib.ssq_fastq_sync.argtypes = [c_char_p, i64, i64]
    lib.ssq_pack_rows.restype = i64
    lib.ssq_pack_rows.argtypes = [p_u8, p_i32, i64, i64, p_u32]
    lib.ssq_gather_pack.restype = i64
    lib.ssq_gather_pack.argtypes = [c_char_p, p_i64, p_i32, i64, i64, p_u32]
    lib.ssq_host_count.restype = i64
    lib.ssq_host_count.argtypes = [p_u32, p_i32, i64, i64, p_u32, p_i32,
                                   p_i64]
    lib.ssq_host_count_inv.restype = i64
    lib.ssq_host_count_inv.argtypes = [p_u32, p_i32, i64, i64, p_u32, p_i32,
                                       p_i64, p_i64]
    lib.ssq_host_count_w.restype = i64
    lib.ssq_host_count_w.argtypes = [p_u32, p_i32, p_i64, i64, i64, p_u32,
                                     p_i32, p_i64]
    lib.ssq_greedy_absorb.restype = None
    lib.ssq_greedy_absorb.argtypes = [p_i64, p_i64, p_i64, p_i64, i64, i32,
                                      p_i64]


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _chars(data):
    """`data` as the library's `const char*`: bytes as they are, a uint8
    numpy buffer by its address (the caller keeps it alive)."""
    if isinstance(data, np.ndarray):
        return ctypes.c_char_p(data.ctypes.data)
    return data


def _index_records(lib, buf, n: int):
    """(starts int64, lengths int32) of every sequence line in the `n`
    bytes at `buf` (bytes or a `const char*`), relative to `buf`."""
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    # One record per 4 lines, plus slack for the parallel indexer's
    # per-span rounding on malformed files; an overflow reports the exact
    # count and is retried once with it.
    cap = lib.ssq_count_lines(buf, n) // 4 + 130
    for _ in range(2):
        starts = np.empty(cap, dtype=np.int64)
        lengths = np.empty(cap, dtype=np.int32)
        n_reads = lib.ssq_fastq_index(
            buf, n, _as_ptr(starts, ctypes.c_int64),
            _as_ptr(lengths, ctypes.c_int32), cap)
        if n_reads >= 0:
            return starts[:n_reads], lengths[:n_reads]
        cap = -n_reads
    raise RuntimeError("fastq index capacity unstable")


def fastq_index_native(data: bytes,
                       byte_range: tuple[int, int] | None = None):
    """Index a FASTQ byte buffer: (synced data, starts int64, lengths int32)
    of every sequence line, without gathering any bytes.  Returns None when
    the native library is missing.

    byte_range (lo, hi) restricts parsing to the records whose boundaries
    ssq_fastq_sync finds inside [lo, hi), returned as bytes of their own.
    """
    lib = get_lib()
    if lib is None:
        return None
    if byte_range is not None:
        n = len(data)
        lo = lib.ssq_fastq_sync(data, n, byte_range[0])
        hi = lib.ssq_fastq_sync(data, n, byte_range[1])
        data = data[lo:hi]
    return (data, *_index_records(lib, data, len(data)))


def fastq_index_in_place(buf: np.ndarray, n: int,
                         byte_range: tuple[int, int]):
    """fastq_index_native's byte_range index of the first `n` bytes of a
    uint8 host buffer, made where the records lie: (buf up to the synced
    end, starts relative to buf, lengths).  Nothing past `n` is read, so
    bytes left in the buffer by an earlier, longer slice never count.
    Returns None when the native library is missing."""
    if buf.dtype != np.uint8 or not buf.flags.c_contiguous \
            or not 0 <= n <= buf.size:
        raise ValueError(f"{n} bytes of a {buf.dtype} buffer of {buf.size}")
    lib = get_lib()
    if lib is None:
        return None
    lo = lib.ssq_fastq_sync(_chars(buf), n, byte_range[0])
    hi = lib.ssq_fastq_sync(_chars(buf), n, byte_range[1])
    starts, lengths = _index_records(lib, _chars(buf[lo:]), hi - lo)
    starts += lo
    return buf[:hi], starts, lengths


def gather_pack_native(data: bytes, starts: np.ndarray, lengths: np.ndarray,
                       width: int):
    """Gather + 2-bit pack indexed rows straight from the file buffer
    (bytes, or a uint8 numpy buffer): [N] (starts, lengths) ->
    [N, width//16] uint32 in the reference bit layout, zero-padded past
    each length (rows longer than width are truncated - callers bucket by
    width first).  Returns None when the
    native library is missing; raises the reference's invalid-base message
    with the offending character."""
    lib = get_lib()
    if lib is None:
        return None
    assert width % 16 == 0
    n = len(starts)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    words = np.empty((n, width // 16), dtype=np.uint32)
    bad = lib.ssq_gather_pack(
        _chars(data), _as_ptr(starts, ctypes.c_int64),
        _as_ptr(lengths, ctypes.c_int32), n, width,
        _as_ptr(words, ctypes.c_uint32))
    if bad:
        from ..constants import UNSUPPORTED_BASE_MSG
        from ..oracle import first_invalid_char

        i = bad - 1
        row = data[starts[i]:starts[i] + min(int(lengths[i]), width)]
        raise Exception(f"{UNSUPPORTED_BASE_MSG}: {first_invalid_char(row)}")
    return words


def fastq_matrix_native(data: bytes, pad_to: int = 16,
                        byte_range: tuple[int, int] | None = None):
    """Parse a FASTQ byte buffer into (PAD_BYTE-padded uint8 matrix,
    lengths), or None when the native library is missing.  byte_range as
    in fastq_index_native."""
    lib = get_lib()
    if lib is None:
        return None
    data, starts, lengths = fastq_index_native(data, byte_range)
    n_reads = len(starts)
    if n_reads == 0:
        return np.zeros((0, pad_to), dtype=np.uint8), lengths
    max_len = lib.ssq_max_length(_as_ptr(lengths, ctypes.c_int32), n_reads)
    width = max(pad_to, -(-max_len // pad_to) * pad_to)
    mat = np.empty((n_reads, width), dtype=np.uint8)
    lib.ssq_gather_padded(
        data, _as_ptr(starts, ctypes.c_int64),
        _as_ptr(lengths, ctypes.c_int32), n_reads, width,
        _as_ptr(mat, ctypes.c_uint8))
    return mat, lengths


def pack_rows_native(mat: np.ndarray, lengths: np.ndarray):
    """Host-side 2-bit packing (the CPU oracle): [N, W] uint8 ->
    [N, W//16] uint32 in the reference bit layout.  Returns None when the
    native library is missing; raises on invalid bases like the reference
    (short_seq_64.pyx:105), naming the first bad read."""
    lib = get_lib()
    if lib is None:
        return None
    n, width = mat.shape
    if width % 16:
        raise ValueError(f"matrix width {width} is not a multiple of 16")
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    words = np.empty((n, width // 16), dtype=np.uint32)
    bad = lib.ssq_pack_rows(
        _as_ptr(mat, ctypes.c_uint8), _as_ptr(lengths, ctypes.c_int32),
        n, width, _as_ptr(words, ctypes.c_uint32))
    if bad:
        from ..constants import UNSUPPORTED_BASE_MSG

        raise Exception(f"{UNSUPPORTED_BASE_MSG} in read {bad - 1}")
    return words


def host_count_native(words: np.ndarray, lengths: np.ndarray,
                      return_inverse: bool = False):
    """Exact dedup of packed rows on the host: [N, W] uint32 + [N] int32 ->
    (unique words [M, W], lengths [M] int32, counts [M] int64[, inverse
    [N] int64]).  Threaded partitioned hash count (csrc ssq_host_count),
    the host engine of the count path.  With return_inverse, inverse[i]
    is the output-table index of input row i.  Returns None when the
    native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, wpr = words.shape
    out_w = np.empty((n, wpr), dtype=np.uint32)
    out_l = np.empty(n, dtype=np.int32)
    out_c = np.empty(n, dtype=np.int64)
    if return_inverse:
        inverse = np.empty(n, dtype=np.int64)
        m = lib.ssq_host_count_inv(
            _as_ptr(words, ctypes.c_uint32), _as_ptr(lengths, ctypes.c_int32),
            n, wpr, _as_ptr(out_w, ctypes.c_uint32),
            _as_ptr(out_l, ctypes.c_int32), _as_ptr(out_c, ctypes.c_int64),
            _as_ptr(inverse, ctypes.c_int64))
        return out_w[:m].copy(), out_l[:m].copy(), out_c[:m].copy(), inverse
    m = lib.ssq_host_count(
        _as_ptr(words, ctypes.c_uint32), _as_ptr(lengths, ctypes.c_int32),
        n, wpr, _as_ptr(out_w, ctypes.c_uint32),
        _as_ptr(out_l, ctypes.c_int32), _as_ptr(out_c, ctypes.c_int64))
    return out_w[:m].copy(), out_l[:m].copy(), out_c[:m].copy()


def host_count_weighted_native(words: np.ndarray, lengths: np.ndarray,
                               weights: np.ndarray):
    """Weighted exact dedup of packed rows: like host_count_native but
    each row contributes weights[i] instead of 1 - the exact merge of
    already-deduped (rows, counts) tables (the streamed host engine
    concatenates per-slice unique tables and re-counts with counts as
    weights).  Returns None when the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    weights = np.ascontiguousarray(weights, dtype=np.int64)
    n, wpr = words.shape
    out_w = np.empty((n, wpr), dtype=np.uint32)
    out_l = np.empty(n, dtype=np.int32)
    out_c = np.empty(n, dtype=np.int64)
    m = lib.ssq_host_count_w(
        _as_ptr(words, ctypes.c_uint32), _as_ptr(lengths, ctypes.c_int32),
        _as_ptr(weights, ctypes.c_int64), n, wpr,
        _as_ptr(out_w, ctypes.c_uint32), _as_ptr(out_l, ctypes.c_int32),
        _as_ptr(out_c, ctypes.c_int64))
    return out_w[:m].copy(), out_l[:m].copy(), out_c[:m].copy()


def greedy_absorb_native(indptr: np.ndarray, indices: np.ndarray,
                         counts: np.ndarray, order: np.ndarray,
                         directional: bool):
    """Count-ordered greedy UMI collapse over a CSR adjacency (csrc
    ssq_greedy_absorb).  Returns labels [U] int64, or None when the
    native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    u = len(counts)
    labels = np.empty(u, dtype=np.int64)
    lib.ssq_greedy_absorb(
        _as_ptr(indptr, ctypes.c_int64), _as_ptr(indices, ctypes.c_int64),
        _as_ptr(counts, ctypes.c_int64), _as_ptr(order, ctypes.c_int64),
        u, 1 if directional else 0, _as_ptr(labels, ctypes.c_int64))
    return labels
