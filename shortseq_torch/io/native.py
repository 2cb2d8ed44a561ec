"""ctypes bindings of the native host library (csrc/fastq_index.cpp) that
the UMI slice calls, from shortseq_tpu/io/native.py.

The library is built by shortseq_torch/_build.py at first use.  Host
code keeps the JAX package's behaviour when it is missing: every function
here returns None, and the callers take their pure-Python paths.
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
    lib.ssq_host_count_inv.restype = i64
    lib.ssq_host_count_inv.argtypes = [p_u32, p_i32, i64, i64, p_u32, p_i32,
                                       p_i64, p_i64]
    lib.ssq_greedy_absorb.restype = None
    lib.ssq_greedy_absorb.argtypes = [p_i64, p_i64, p_i64, p_i64, i64, i32,
                                      p_i64]


def _as_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _fastq_index(lib, data: bytes):
    """(starts int64, lengths int32) of every sequence line of a FASTQ
    buffer."""
    n = len(data)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int32)
    # One record per 4 lines, plus slack for the parallel indexer's
    # per-span rounding on malformed files; an overflow reports the exact
    # count and is retried once with it.
    cap = lib.ssq_count_lines(data, n) // 4 + 130
    for _ in range(2):
        starts = np.empty(cap, dtype=np.int64)
        lengths = np.empty(cap, dtype=np.int32)
        n_reads = lib.ssq_fastq_index(
            data, n, _as_ptr(starts, ctypes.c_int64),
            _as_ptr(lengths, ctypes.c_int32), cap)
        if n_reads >= 0:
            return starts[:n_reads], lengths[:n_reads]
        cap = -n_reads
    raise RuntimeError("fastq index capacity unstable")


def fastq_matrix_native(data: bytes, pad_to: int = 16):
    """Parse a FASTQ byte buffer into (PAD_BYTE-padded uint8 matrix,
    lengths), or None when the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    starts, lengths = _fastq_index(lib, data)
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


def host_count_native(words: np.ndarray, lengths: np.ndarray):
    """Exact dedup of packed rows on the host: [N, W] uint32 + [N] int32 ->
    (unique words [M, W], lengths [M] int32, counts [M] int64, inverse
    [N] int64) - the JAX package's return_inverse=True form, the only one
    the slice calls.  Returns None when the native library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    n, wpr = words.shape
    out_w = np.empty((n, wpr), dtype=np.uint32)
    out_l = np.empty(n, dtype=np.int32)
    out_c = np.empty(n, dtype=np.int64)
    inverse = np.empty(n, dtype=np.int64)
    m = lib.ssq_host_count_inv(
        _as_ptr(words, ctypes.c_uint32), _as_ptr(lengths, ctypes.c_int32),
        n, wpr, _as_ptr(out_w, ctypes.c_uint32),
        _as_ptr(out_l, ctypes.c_int32), _as_ptr(out_c, ctypes.c_int64),
        _as_ptr(inverse, ctypes.c_int64))
    return out_w[:m].copy(), out_l[:m].copy(), out_c[:m].copy(), inverse


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
