"""UMI deduplication: batched pairwise-hamming clustering, in PyTorch.

Counterpart of shortseq_tpu/umi/dedup.py with the same methods and the
same labels and representatives, byte for byte:

  unique       - exact UMIs only (one cluster per UMI)
  cluster      - connected components of the <=threshold hamming graph
  adjacency    - greedy: highest-count node absorbs its direct neighbours,
                 repeat on the remainder
  directional  - edge u->v only if count(u) >= 2*count(v) - 1; clusters
                 are BFS trees from high-count roots (umi_tools' default)

Pipeline:

  group     - unique (insert, UMI) keys + counts + per-item inverse, on
              the host: every input, a list or a matrix, is one padded
              uint8 matrix and its lengths, grouped one length bucket
              at a time (_group_buckets) by _unique_rows, which runs the
              threaded native hash counter when built and numpy
              otherwise.  One function groups reads
              (_dedup_reads_ragged), one UMIs (_dedup_umis_ragged).
  pack      - the unique UMIs are packed and validated on `device`
              (kernel A, ops/bitpack.py).
  adjacency - kernel H (csrc/umi.cu) finds every row's first k neighbour
              columns and its true neighbour count in one launch, with no
              distance slab; only those cross to the host.  Rows with more
              than k neighbours are re-extracted at _OVERFLOW_K (kernel B
              writes an L2-sized [rows, U] slab a batch, kernel C reduces
              it; every batch queued, one fetch), and rows beyond that
              take a dense mask fetch.  With `mesh=`, kernel H's rows split
              into one band a rank (dist/umi.py), gathered in rank order.
  collapse  - host graph walk over the lists, one CSR, O(edges).

`dedup_fastq` is the CLI's path (`python -m shortseq_torch umi`): a FASTQ
file read into a padded matrix, then the grouping over that matrix.  One
call of it is one tree of ranges under `ssq.umi_dedup` (utils/profiling.py
lists them), opened only while a profiler records.  `_neighbor_lists`
counts its work on itself: `.rows` (candidate rows), `.pairs` (rows x the
padded columns kernel H compares), `.group_pairs` (sum of g * (g - 1)
over the group ids, g a group's rows: the ordered pairs inside a group,
the problem's own work), `.overflow_rows` (rows over k), `.edges`
(neighbours found) and `.umi_lanes` (32-bit lanes the rows' UMIs fill);
`_dedup_reads_ragged.padded_reads` counts the reads that came as a padded
matrix (every read of `dedup_fastq`, and a uint8 matrix given to
`dedup_reads`), `.list_reads` those laid into one from a list.

`device` is explicit everywhere: "cuda" (the default) runs the kernels
and raises when there is no card; "cpu" runs their plain PyTorch
versions; with a mesh the device is the mesh's.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..constants import MAX_64_NT, NT_PER_LANE
from ..ops.bitpack import pack_and_validate_rows
from ..ops.lanes import from_numpy_u32
from ..ops.pairwise import hamming_pairwise_tiled
from ..utils.profiling import named_scope, scoped

# Memory budget for one row chunk of kernel H's plain version: rows * U
# int32 distances stay under ~1 GiB (16384^2 * 4 B).  The default `block`
# of _neighbor_lists (its row padding quantum) comes from it too, as in
# the JAX package.
_PAIR_BUDGET = 16384 * 16384

_METHODS = ("unique", "cluster", "adjacency", "directional")

# Per-row neighbour cap of the main pass (kernel H).  UMI graphs are
# sparse; rows over the cap are re-extracted at _OVERFLOW_K (kernels B +
# C) in batches of at least _DENSE_ROWS_BATCH rows, more while a batch's
# [rows, U] slab stays within _OVERFLOW_SLAB entries (L2-sized), and only
# rows beyond THAT (threshold >= 2 pathologies) take a dense mask fetch,
# _DENSE_ROWS_BATCH rows at a time.
_NEIGHBOR_K = 16
_OVERFLOW_K = 128
_DENSE_ROWS_BATCH = 256
_OVERFLOW_SLAB = 5 << 20

# Column segments a row of kernel C (0: the kernel picks from the slab's
# shape).
_EXTRACT_SEGS = 0


_resolve_device = _build.resolve_device


def _dedup_device(device, mesh) -> torch.device:
    """The device of a dedup call: with a mesh, mesh.device (a `device`
    that names another one raises ValueError); without, `device` ("cuda"
    when None, which raises without a card)."""
    if mesh is None:
        return _resolve_device("cuda" if device is None else device)
    if device is not None:
        d, m = torch.device(device), mesh.device
        if d.type != m.type or d.index not in (None, m.index):
            raise ValueError(f"device {d} is not the mesh's device {m}")
    return mesh.device


@scoped("ssq.umi_pack")
def _pack_validate_matrix(mat, lengths, device):
    """Pack an [N, <=32] uint8 UMI byte matrix -> [N, 2] int32 words on
    `device` (kernel A), raising the reference's error on any invalid
    base.  Pad bytes are 0x00, which fails the bloom, so the length mask
    is on (pad_valid=False)."""
    from ..constants import UNSUPPORTED_BASE_MSG
    from ..utils.warmup import start_transfer_warmup

    start_transfer_warmup(device)
    width = 32
    if mat.shape[1] != width:
        mat = np.pad(mat, ((0, 0), (0, width - mat.shape[1])))
    lengths = np.ascontiguousarray(lengths, np.int32)
    words, ok = pack_and_validate_rows(
        np.ascontiguousarray(mat).view(np.uint32), lengths, device=device)
    ok = ok.cpu().numpy()
    if not ok.all():
        i = int(np.argmin(ok))
        bad = mat[i, :lengths[i]].tobytes().decode("ascii", "replace")
        raise Exception(f"{UNSUPPORTED_BASE_MSG} in UMI {bad!r}")
    return words


def _first_order(inverse, m):
    """The m keys of rows whose key is inverse[i], in order of first
    occurrence: (first [m], each key's first row in that order; order,
    the keys in that order; rank [m], each key's place in it)."""
    first = np.empty(m, np.int64)
    # Later writes win, so writing rows in descending order leaves each
    # key its smallest row.
    first[inverse[::-1]] = np.arange(len(inverse) - 1, -1, -1,
                                     dtype=np.int64)
    order = np.argsort(first, kind="stable")
    rank = np.empty(m, np.int64)
    rank[order] = np.arange(m, dtype=np.int64)
    return first[order], order, rank


def _unique_rows(mat):
    """np.unique(mat, axis=0, return_counts+inverse) in global
    first-occurrence order: (unique [M, L] uint8, counts [M] int64,
    inverse [N] int64).  Runs the threaded native hash counter when
    built; numpy's unique over the rows, each one void field, is its
    behavioural twin."""
    from ..io.native import host_count_native

    n, ncol = mat.shape
    if ncol == 0:
        # Zero-width rows are all equal.
        return (np.zeros((1, 0), np.uint8), np.array([n], np.int64),
                np.zeros(n, np.int64))
    mat = np.ascontiguousarray(mat)
    pad = -ncol % 4
    words = np.pad(mat, ((0, 0), (0, pad))) if pad else mat
    res = host_count_native(words.view(np.uint32), np.full(n, ncol, np.int32),
                            return_inverse=True)
    if res is None:
        _, inverse, counts = np.unique(
            mat.view(np.dtype((np.void, ncol)))[:, 0], return_inverse=True,
            return_counts=True)
    else:
        # The native table is first-occurrence-ordered per hash partition.
        _, _, counts, inverse = res
    first, order, rank = _first_order(inverse, len(counts))
    return mat[first], counts[order], rank[inverse]


def umi_adjacency(words, lengths, threshold: int = 1) -> np.ndarray:
    """[U, W] packed UMIs (a tensor on its device, or a numpy uint32
    array, which goes to the CPU) -> boolean [U, U] adjacency on the host:
    hamming <= threshold and equal length.  Dense, through the calibrated
    pairwise selector; the dedup paths use _neighbor_lists instead."""
    from ..ops.pairwise import pairwise_hamming_auto

    dist = pairwise_hamming_auto(words, words).cpu().numpy()
    lengths = np.asarray(lengths)
    return (dist <= threshold) & np.equal.outer(lengths, lengths)


# --- Kernel C: neighbour extraction -----------------------------------------


def _adjacency(dist, a_lengths, a_gids, a_rows, lengths, gids,
               threshold: int) -> torch.Tensor:
    """[B, U] bool: dist <= threshold, equal length, equal group id, and
    not the row itself (a_rows are the rows' global column ids)."""
    cols = torch.arange(dist.shape[1], dtype=torch.int32, device=dist.device)
    return ((dist <= threshold)
            & (a_lengths[:, None] == lengths[None, :])
            & (a_gids[:, None] == gids[None, :])
            & (cols[None, :] != a_rows[:, None]))


def neighbor_extract_plain(dist, a_lengths, a_gids, a_rows, lengths, gids,
                           threshold: int, k: int):
    """Plain PyTorch version of kernel C: (idx [B, k] int32, each row's
    first k neighbour columns ascending with empty slots = U; cnt [B]
    int32, the true neighbour count)."""
    b, u = dist.shape
    adj = _adjacency(dist, a_lengths, a_gids, a_rows, lengths, gids,
                     threshold)
    cnt = adj.sum(dim=1, dtype=torch.int32)
    pos = adj.cumsum(dim=1, dtype=torch.int32) - 1
    r, c = (adj & (pos < k)).nonzero(as_tuple=True)
    idx = torch.full((b, k), u, dtype=torch.int32, device=dist.device)
    idx[r, pos[r, c].long()] = c.to(torch.int32)
    return idx, cnt


def neighbor_extract(dist, a_lengths, a_gids, a_rows, lengths, gids,
                     threshold: int, k: int, out=None):
    """Kernel C: the [B, U] int32 distance slab -> (idx [B, k], cnt [B]),
    the same encoding as the JAX package's _adjacency_score +
    _extract_ascending.  `out`, when given, is an (idx, cnt) pair of
    contiguous int32 tensors of those shapes that receives the result.  A
    CUDA slab launches the kernel; a CPU slab takes the plain version."""
    b, u = dist.shape
    if out is not None:
        for name, t, shape in (("idx", out[0], (b, k)), ("cnt", out[1], (b,))):
            if tuple(t.shape) != shape or t.dtype != torch.int32 \
                    or not t.is_contiguous():
                raise ValueError(f"out {name} must be a contiguous {shape} "
                                 f"int32 tensor, got {tuple(t.shape)} "
                                 f"{t.dtype}")
    if dist.device.type == "cpu":
        got = neighbor_extract_plain(dist, a_lengths, a_gids, a_rows,
                                     lengths, gids, threshold, k)
        if out is None:
            return got
        out[0].copy_(got[0])
        out[1].copy_(got[1])
        return out
    dev = dist.device
    _build.check_operand(dist, "dist", torch.int32, 2, dev)
    for name, t, n in (("a_lengths", a_lengths, b), ("a_gids", a_gids, b),
                       ("a_rows", a_rows, b), ("lengths", lengths, u),
                       ("gids", gids, u)):
        _build.check_operand(t, name, torch.int32, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")
    if out is None:
        out = (torch.empty((b, k), dtype=torch.int32, device=dev),
               torch.empty(b, dtype=torch.int32, device=dev))
    idx, cnt = out
    for name, t in (("idx", idx), ("cnt", cnt)):
        if t.device != dev:
            raise ValueError(f"out {name} is on {t.device}, expected {dev}")
    _build.launch("ssq_neighbor_extract", dist.data_ptr(),
                  a_lengths.data_ptr(), a_gids.data_ptr(), a_rows.data_ptr(),
                  lengths.data_ptr(), gids.data_ptr(), idx.data_ptr(),
                  cnt.data_ptr(), b, u, int(threshold), int(k), _EXTRACT_SEGS)
    neighbor_extract.launches += 1
    return idx, cnt


neighbor_extract.launches = 0


# --- Kernel H: fused neighbour lists ----------------------------------------


def neighbor_lists_fused_plain(a_words, a_lengths, a_gids, a_rows, words,
                               lengths, gids, threshold: int, k: int):
    """Plain PyTorch version of kernel H: row chunks of the plain
    hamming_pairwise (each within _PAIR_BUDGET distances), each reduced
    by neighbor_extract_plain.  Same (idx [R, k], cnt [R]) as
    neighbor_lists_fused."""
    from ..ops.hamming import hamming_pairwise

    r, u = a_words.shape[0], words.shape[0]
    if r == 0:
        return (torch.empty((0, k), dtype=torch.int32, device=words.device),
                torch.empty(0, dtype=torch.int32, device=words.device))
    step = max(1, _PAIR_BUDGET // max(u, 1))
    idx_parts, cnt_parts = [], []
    for lo in range(0, r, step):
        sl = slice(lo, lo + step)
        idx, cnt = neighbor_extract_plain(
            hamming_pairwise(a_words[sl], words), a_lengths[sl], a_gids[sl],
            a_rows[sl], lengths, gids, threshold, k)
        idx_parts.append(idx)
        cnt_parts.append(cnt)
    return torch.cat(idx_parts), torch.cat(cnt_parts)


def neighbor_lists_fused(a_words, a_lengths, a_gids, a_rows, words, lengths,
                         gids, threshold: int, k: int):
    """Kernel H: the neighbour lists of the R query rows `a_words` ([R, W]
    int32 lanes, W <= 2, with their lengths, group ids and own column ids
    `a_rows`) among the U columns `words` -> (idx [R, k] int32, each row's
    first k neighbour columns ascending with empty slots = U; cnt [R]
    int32, the true neighbour count).  What kernel B then kernel C
    compute, with no [R, U] slab.  A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    if a_words.dim() != 2 or words.dim() != 2 or \
            a_words.shape[1] != words.shape[1]:
        raise ValueError(f"neighbour operands must be [R, W] and [U, W], got "
                         f"{tuple(a_words.shape)} and {tuple(words.shape)}")
    if words.device.type == "cpu":
        return neighbor_lists_fused_plain(a_words, a_lengths, a_gids, a_rows,
                                          words, lengths, gids, threshold, k)
    dev = words.device
    r, w = a_words.shape
    u = words.shape[0]
    _build.check_operand(a_words, "a_words", torch.int32, 2, dev)
    _build.check_operand(words, "words", torch.int32, 2, dev)
    if not 1 <= w <= 2:
        raise ValueError(f"kernel H takes 1 or 2 lanes (UMIs of up to 32 nt), "
                         f"got {w}")
    if u >= 2**31:
        raise ValueError(f"kernel H takes fewer than 2^31 columns, got {u}")
    for name, t, n in (("a_lengths", a_lengths, r), ("a_gids", a_gids, r),
                       ("a_rows", a_rows, r), ("lengths", lengths, u),
                       ("gids", gids, u)):
        _build.check_operand(t, name, torch.int32, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")
    idx = torch.empty((r, k), dtype=torch.int32, device=dev)
    cnt = torch.empty(r, dtype=torch.int32, device=dev)
    if r == 0:
        return idx, cnt
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = _build.cuda_lib().ssq_neighbor_lists_splits(r, u, int(k), sms)
    if splits == 1:
        # One column range: the kernel appends straight into idx / cnt.
        sidx, scnt = idx, cnt
    else:
        sidx = torch.empty((splits, r, k), dtype=torch.int32, device=dev)
        scnt = torch.empty((splits, r), dtype=torch.int32, device=dev)
    _build.launch("ssq_neighbor_lists", a_words.data_ptr(),
                  a_lengths.data_ptr(), a_gids.data_ptr(), a_rows.data_ptr(),
                  words.data_ptr(), lengths.data_ptr(), gids.data_ptr(),
                  sidx.data_ptr(), scnt.data_ptr(), idx.data_ptr(),
                  cnt.data_ptr(), r, u, w, int(threshold), int(k), sms)
    neighbor_lists_fused.launches += 1
    return idx, cnt


neighbor_lists_fused.launches = 0


class _NeighborCsr:
    """Neighbour lists as one CSR: row i's neighbours are
    indices[indptr[i]:indptr[i + 1]] (int64, ascending); len() is the
    row count."""

    __slots__ = ("indptr", "indices")

    def __init__(self, indptr, indices):
        self.indptr, self.indices = indptr, indices

    def __len__(self):
        return len(self.indptr) - 1


@scoped("ssq.umi_neighbors")
def _neighbor_lists(words, lengths, threshold, gids=None, block=None,
                    mesh=None, *, device=None):
    """Sparse adjacency as one _NeighborCsr: row i's neighbours are the
    indices j != i with hamming(i, j) <= threshold, equal lengths, and
    (optionally) equal group ids, ascending, as the JAX package lists
    them.  `words` is an int32 tensor or a numpy uint32 array.
    The main pass is one call of kernel H over all rows on `device`: no
    distance slab is written, and host memory and transfer are
    O(U * k + edges), never O(U^2).  Rows with more than k neighbours
    take kernels B + C at a larger cap, all their batches queued and
    fetched once, and rows beyond that a dense mask (on [rows, U] slabs of
    at most max(_DENSE_ROWS_BATCH, _OVERFLOW_SLAB / U) rows).

    With a mesh (dist.data_mesh), the main pass splits into row bands over
    its ranks (dist/umi.py) on mesh.device, and every rank then runs the
    overflow tier on the gathered counts, so all ranks return the same
    CSR; every rank calls with the same operands."""
    device = _dedup_device(device, mesh)
    u = len(lengths)
    if u == 0:
        return _NeighborCsr(np.zeros(1, np.int64), np.zeros(0, np.int64))
    lengths = np.asarray(lengths)
    if block is None:
        block = max(256, min(u, _PAIR_BUDGET // max(u, 1)))
        # Multiple of 128, as in the JAX package, so both packages pad to
        # the same column count (kernel C itself needs no rounding).
        block = -(-block // 128) * 128
    k = min(_NEIGHBOR_K, u)
    # Pad the row count to a multiple of block (x ranks) with rows that
    # match nothing real (length -1); their lists are sliced off below.
    quantum = block * (mesh.size if mesh is not None else 1)
    u_pad = -(-u // quantum) * quantum
    group = np.bincount(np.asarray(gids)) if gids is not None \
        else np.array([u], np.int64)
    _neighbor_lists.rows += u
    _neighbor_lists.pairs += u * u_pad
    _neighbor_lists.group_pairs += int((group * (group - 1)).sum())
    _neighbor_lists.umi_lanes += int(
        (-(-lengths.astype(np.int64) // NT_PER_LANE)).sum())
    if isinstance(words, np.ndarray):
        words = from_numpy_u32(words)
    words = words.to(device)
    words_d = torch.zeros((u_pad, words.shape[1]), dtype=torch.int32,
                          device=device)
    words_d[:u] = words
    lengths_d = torch.full((u_pad,), -1, dtype=torch.int32, device=device)
    lengths_d[:u] = torch.from_numpy(lengths.astype(np.int32)).to(device)
    gids_d = torch.zeros(u_pad, dtype=torch.int32, device=device)
    if gids is not None:
        gids_d[:u] = torch.from_numpy(
            np.asarray(gids).astype(np.int32)).to(device)

    # The real rows against every column; the pad rows' lists would be
    # sliced off, so they are not computed.
    if mesh is not None:
        from ..dist.umi import neighbors_sharded_step

        idx, cnt = neighbors_sharded_step(mesh, threshold, k, block)(
            words_d, lengths_d, gids_d, u)
    else:
        rows_d = torch.arange(u, dtype=torch.int32, device=device)
        idx, cnt = neighbor_lists_fused(
            words_d[:u], lengths_d[:u], gids_d[:u], rows_d, words_d,
            lengths_d, gids_d, threshold, k)
        idx, cnt = idx.cpu().numpy(), cnt.cpu().numpy()
    # Empty slots carry the padded column count (the mesh's, with a mesh).
    valid = idx < u_pad
    # Every tier gives (row, column) pairs, rows ascending and each row's
    # columns ascending (boolean masking flattens row-major), so one stable
    # sort by row splices them into the CSR, in place of the overflow
    # rows' main-pass slots.
    over = np.flatnonzero(cnt > k)
    _neighbor_lists.overflow_rows += over.size
    valid[over] = False
    rows = [np.repeat(np.arange(u), valid.sum(axis=1))]
    cols = [idx[valid]]

    # Rows with more than k neighbours are re-extracted at a larger cap:
    # their ids go to `device` once, each batch's kernel B (into one shared
    # slab) and kernel C (into its rows of one [n_over, k2] / [n_over]
    # pair) are queued with no sync between batches (stream order makes
    # reusing the slab safe), and the pair is fetched once.  Rows beyond
    # even k2 (threshold >= 2 pathologies; threshold 1 is bounded by
    # 3L <= 96 < _OVERFLOW_K) take one dense mask fetch per batch of
    # _DENSE_ROWS_BATCH.
    if over.size:
        k2 = min(_OVERFLOW_K, u_pad)
        n_over = over.size
        p = min(n_over, max(_DENSE_ROWS_BATCH, _OVERFLOW_SLAB // u_pad))
        over_d = torch.from_numpy(over.astype(np.int32)).to(device)
        a_words, a_lengths, a_gids = (t[over_d]
                                      for t in (words_d, lengths_d, gids_d))
        idx2 = torch.empty((n_over, k2), dtype=torch.int32, device=device)
        cnt2 = torch.empty(n_over, dtype=torch.int32, device=device)
        slab = torch.empty((p, u_pad), dtype=torch.int32, device=device)
        for lo in range(0, n_over, p):
            hi = min(lo + p, n_over)
            part = slab[:hi - lo]
            hamming_pairwise_tiled(a_words[lo:hi], words_d, out=part)
            neighbor_extract(part, a_lengths[lo:hi], a_gids[lo:hi],
                             over_d[lo:hi], lengths_d, gids_d, threshold, k2,
                             out=(idx2[lo:hi], cnt2[lo:hi]))
        idx2, cnt2 = idx2.cpu().numpy(), cnt2.cpu().numpy()
        fits = cnt2 <= k2
        sub = idx2[fits]
        keep = sub < u_pad
        rows.append(np.repeat(over[fits], keep.sum(axis=1)))
        cols.append(sub[keep])
        still = over[~fits]
        still_d = torch.from_numpy(still.astype(np.int32)).to(device)
        for lo in range(0, still.size, _DENSE_ROWS_BATCH):
            sel = still_d[lo:lo + _DENSE_ROWS_BATCH]
            part = slab[:sel.numel()]
            hamming_pairwise_tiled(words_d[sel], words_d, out=part)
            adj = _adjacency(part, lengths_d[sel], gids_d[sel], sel,
                             lengths_d, gids_d, threshold).cpu().numpy()
            r, c = np.nonzero(adj[:, :u])
            rows.append(still[lo:lo + _DENSE_ROWS_BATCH][r])
            cols.append(c)
    rows = np.concatenate(rows)
    indptr = np.zeros(u + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=u), out=indptr[1:])
    indices = np.concatenate(cols).astype(np.int64)[
        np.argsort(rows, kind="stable")]
    _neighbor_lists.edges += len(indices)
    return _NeighborCsr(indptr, indices)


_neighbor_lists.rows = 0
_neighbor_lists.pairs = 0
_neighbor_lists.group_pairs = 0
_neighbor_lists.overflow_rows = 0
_neighbor_lists.edges = 0
_neighbor_lists.umi_lanes = 0


# --- Host collapse (the JAX package's, over a CSR) -------------------------


def _components(nbrs):
    """Connected components over a _NeighborCsr; each node's label is its
    component's MINIMUM node index.  Vectorized min-label propagation
    with pointer-jumping path compression."""
    u = len(nbrs)
    labels = np.arange(u, dtype=np.int64)
    dst = nbrs.indices
    if len(dst) == 0:
        return labels
    src = np.repeat(np.arange(u, dtype=np.int64), np.diff(nbrs.indptr))
    while True:
        m = labels.copy()
        # Adjacency is symmetric, so one directed pass reaches both ends.
        np.minimum.at(m, src, labels[dst])
        # m[i] <= i throughout, so m is a parent forest and jumping
        # strictly descends.
        while True:
            mm = m[m]
            if np.array_equal(mm, m):
                break
            m = mm
        if np.array_equal(m, labels):
            return labels
        labels = m


def _greedy_absorb(nbrs, counts, directional: bool):
    """adjacency / directional collapse over a _NeighborCsr: iterate nodes
    by descending count; an unassigned node roots a cluster and absorbs
    unassigned neighbours (direct only for adjacency; BFS through
    count-ordered edges for directional, edge u->v iff
    counts[u] >= 2 * counts[v] - 1).  Runs in the native library when
    built; the Python loop below is its behavioural twin."""
    from ..io.native import greedy_absorb_native

    u = len(nbrs)
    counts = np.asarray(counts, np.int64)
    order = np.argsort(-counts, kind="stable")
    native = greedy_absorb_native(nbrs.indptr, nbrs.indices, counts, order,
                                  directional)
    if native is not None:
        return native
    indptr, indices = nbrs.indptr.tolist(), nbrs.indices.tolist()
    labels = np.full(u, -1, np.int64)
    for root in order:
        if labels[root] >= 0:
            continue
        labels[root] = root
        frontier = [root]
        while frontier:
            node = frontier.pop()
            for nbr in indices[indptr[node]:indptr[node + 1]]:
                if labels[nbr] >= 0:
                    continue
                if directional and counts[node] < 2 * counts[nbr] - 1:
                    continue
                labels[nbr] = root
                if directional:
                    frontier.append(nbr)
    return labels


def _collapse(nbrs, counts, method):
    if method == "cluster":
        return _components(nbrs)
    return _greedy_absorb(nbrs, counts, method == "directional")


def _relabel(roots, counts):
    """roots -> (dense cluster labels, representative node per cluster =
    the lowest-index max-count member)."""
    uniq_roots, labels = np.unique(roots, return_inverse=True)
    # Sort by (label asc, count desc, index asc); the first row of each
    # label run is its representative.
    order = np.lexsort((np.arange(len(roots)), -counts, labels))
    first = np.searchsorted(labels[order], np.arange(len(uniq_roots)))
    rep_nodes = order[first]
    return labels.astype(np.int64), rep_nodes


def split_read(read: bytes, len_5p: int, len_3p: int):
    """(5' UMI, insert, 3' UMI) of one read.  A read that is entirely UMI
    yields an empty insert."""
    if len_5p < 0 or len_3p < 0:
        raise ValueError("UMI lengths must be non-negative")
    n = len(read)
    if n < len_5p + len_3p:
        raise ValueError(
            f"Read of {n} nt is shorter than the UMI lengths "
            f"({len_5p} + {len_3p})")
    umi5 = read[:len_5p]
    umi3 = read[n - len_3p:] if len_3p else b""
    insert = read[len_5p:n - len_3p]
    return umi5, insert, umi3


def _cluster_unique(words, lengths, counts, method, threshold, gids=None,
                    candidates=None, block=None, mesh=None, *, device):
    """Shared collapse step: returns root per unique key.  `candidates`
    restricts the (quadratic) adjacency work to the given key indices;
    keys outside it root themselves."""
    u = len(lengths)
    roots = np.arange(u)
    if method == "unique" or u < 2:
        return roots
    if candidates is None:
        candidates = np.arange(u)
    if len(candidates) < 2:
        return roots
    if len(candidates) < u:
        words = words[torch.from_numpy(candidates).to(words.device)]
    sub_gids = gids[candidates] if gids is not None else None
    nbrs = _neighbor_lists(words, lengths[candidates], threshold,
                           gids=sub_gids, block=block, mesh=mesh,
                           device=device)
    with named_scope("ssq.umi_collapse"):
        sub_roots = _collapse(nbrs, counts[candidates], method)
        roots[candidates] = candidates[sub_roots]
    return roots


def _length_buckets(lengths_all):
    """Yield (length, ascending original indices) per distinct length in
    ascending length order: one stable argsort + searchsorted split."""
    order = np.argsort(lengths_all, kind="stable")
    sorted_lens = lengths_all[order]
    uniq_lens = np.unique(sorted_lens)
    bounds = np.searchsorted(sorted_lens, uniq_lens)
    bounds = np.append(bounds, len(order))
    for i, lng in enumerate(uniq_lens):
        yield int(lng), order[bounds[i]:bounds[i + 1]]


def _group_buckets(mat, lengths_all, each):
    """The unique rows of a padded [N, W] uint8 matrix, row i being
    `mat[i, :lengths_all[i]]`, in global first-occurrence order.  Rows of
    different lengths never match, so each length bucket is grouped on
    its own (_unique_rows) and the buckets' keys are then ranked
    together.  `each(length, unique)` maps a bucket's unique rows [m,
    length] to a tuple of per-key arrays.  Returns (counts [U], inverse
    [N], first [U], parts): first[k] is key k's first row, and parts
    holds each's arrays, the buckets' joined in the keys' order."""
    inverse = np.empty(len(lengths_all), np.int64)
    counts, parts = [], []
    u = 0
    for lng, idx in _length_buckets(lengths_all):
        uniq, cnt, inv = _unique_rows(np.ascontiguousarray(mat[idx, :lng]))
        inverse[idx] = inv + u
        u += len(cnt)
        counts.append(cnt)
        parts.append(each(lng, uniq))
    first, order, rank = _first_order(inverse, u)
    return (np.concatenate(counts)[order], rank[inverse], first,
            [np.concatenate(p)[order] for p in zip(*parts)])


def _padded_rows(items):
    """A list of str/bytes laid into one zero-padded [N, longest] uint8
    matrix, row i holding item i, and the [N] int64 lengths: the input
    form of _dedup_reads_ragged and _dedup_umis_ragged."""
    norm = [x.encode("ascii") if isinstance(x, str) else bytes(x)
            for x in items]
    lengths = np.fromiter(map(len, norm), np.int64, len(norm))
    mat = np.zeros((len(norm), int(lengths.max())), np.uint8)
    mat[np.arange(mat.shape[1]) < lengths[:, None]] = np.frombuffer(
        b"".join(norm), np.uint8)
    return mat, lengths


def _dedup_umis_ragged(mat, lengths_all, method, threshold, block, device,
                       mesh=None):
    """dedup_umis over UMIs held as a padded [N, W] uint8 matrix and [N]
    lengths, UMI i being `mat[i, :lengths_all[i]]`: UMIs of different
    lengths never cluster, so they are grouped one length at a time."""
    if lengths_all.max() > MAX_64_NT:
        raise ValueError("UMIs longer than 32 nt are not supported")
    counts, inverse, first, (umis,) = _group_buckets(
        mat, lengths_all,
        lambda lng, uniq: (np.pad(uniq, ((0, 0), (0, MAX_64_NT - lng))),))
    lengths = lengths_all[first].astype(np.int32)
    words = _pack_validate_matrix(umis, lengths, device)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            block=block, mesh=mesh, device=device)
    labels_u, rep_nodes = _relabel(roots, counts)
    return labels_u[inverse], [umis[i, :lengths[i]].tobytes()
                               for i in rep_nodes]


def dedup_umis(umis, threshold: int = 1, method: str = "directional",
               _block=None, mesh=None, device=None):
    """Collapse a list of UMIs (str/bytes), or an [N, L] uint8 matrix,
    into clusters on `device` ("cuda" by default; "cpu" runs the plain
    versions).  With `mesh` (dist.data_mesh), every rank of it calls with
    the same UMIs, the neighbour search splits into row bands over the
    ranks on mesh.device, and every rank returns the same result.

    Returns (labels, representatives): `labels[i]` is the cluster id of
    input i (ids are indices into `representatives`), and
    `representatives[c]` is the highest-count UMI of cluster c (bytes).
    """
    if method not in _METHODS:
        raise ValueError(f"Unknown method: {method}")
    device = _dedup_device(device, mesh)
    if len(umis) == 0:
        return np.zeros(0, np.int64), []
    if isinstance(umis, np.ndarray) and umis.ndim == 2:
        if umis.dtype != np.uint8:
            raise TypeError("array input must be a 2-D uint8 UMI matrix")
        mat, lengths = umis, np.full(len(umis), umis.shape[1], np.int64)
    else:
        mat, lengths = _padded_rows(umis)
    return _dedup_umis_ragged(mat, lengths, method, threshold, _block,
                              device, mesh)


def _dedup_reads_ragged(mat, lengths_all, len_5p, len_3p, method,
                        threshold, block, device, mesh=None):
    """dedup_reads over reads held as a padded [N, W] uint8 matrix and [N]
    lengths, read i being `mat[i, :lengths_all[i]]`.  A unique (insert,
    UMI) key is a unique read, and reads of different lengths never share
    an insert, so both the keys and their inserts are grouped one read
    length at a time.  The first read shorter than the UMIs raises
    split_read's error."""
    umi_len = len_5p + len_3p
    short = np.flatnonzero(lengths_all < umi_len)
    if short.size:
        i = short[0]
        split_read(mat[i, :lengths_all[i]].tobytes(), len_5p, len_3p)
    groups = 0

    def inserts_and_umis(lng, uniq):
        nonlocal groups
        ins = _unique_rows(np.ascontiguousarray(uniq[:, len_5p:lng - len_3p]))
        gids = ins[2] + groups
        groups += len(ins[1])
        return gids, np.concatenate([uniq[:, :len_5p], uniq[:, lng - len_3p:]],
                                    axis=1)

    with named_scope("ssq.umi_group"):
        counts, inverse, first, (gids, umi_mat) = _group_buckets(
            mat, lengths_all, inserts_and_umis)
    lengths = np.full(len(counts), umi_len, np.int32)
    words = _pack_validate_matrix(umi_mat, lengths, device)

    group_sizes = np.bincount(gids)
    candidates = np.flatnonzero(group_sizes[gids] >= 2)
    roots = _cluster_unique(words, lengths, counts, method, threshold,
                            gids=gids, candidates=candidates, block=block,
                            mesh=mesh, device=device)
    with named_scope("ssq.umi_collapse"):
        labels_u, rep_nodes = _relabel(roots, counts)
        # A molecule's insert is sliced from the row of its
        # representative key's first read.
        width = mat.shape[1]
        reads = first[rep_nodes]
        rows = mat[reads].tobytes()
        ends = (lengths_all[reads] - len_3p).tolist()
        umis = umi_mat[rep_nodes].tobytes()
        molecules = [(rows[k * width + len_5p:k * width + e],
                      umis[k * umi_len:(k + 1) * umi_len])
                     for k, e in enumerate(ends)]
        return labels_u[inverse], molecules


_dedup_reads_ragged.padded_reads = 0
_dedup_reads_ragged.list_reads = 0


def _check_read_args(len_5p, len_3p, method):
    """dedup_reads' argument checks, with the reference's messages."""
    if method not in _METHODS:
        raise ValueError(f"Unknown method: {method}")
    if len_5p < 0 or len_3p < 0:
        raise ValueError("UMI lengths must be non-negative")
    if len_5p + len_3p == 0:
        raise ValueError("at least one UMI length must be positive")
    if len_5p + len_3p > MAX_64_NT:
        raise ValueError("UMIs longer than 32 nt are not supported")


def dedup_reads(reads, len_5p: int = 0, len_3p: int = 0,
                threshold: int = 1, method: str = "directional",
                _block=None, mesh=None, device=None):
    """Full UMI read deduplication on `device`: reads carrying UMIs on the
    5'/3' ends are grouped by insert sequence, and within each group the
    UMIs are clustered; each cluster is one original molecule.

    Only keys whose insert group holds >= 2 distinct UMIs do quadratic
    work, in memory-bounded row blocks with a group-id mask so edges
    never cross inserts.

    Args:
      reads: list of str/bytes (UMI(s) still attached), or an [N, L]
        uint8 matrix of uniform-length reads.
      len_5p/len_3p: UMI lengths clipped from each end.
      mesh: a dist.data_mesh whose ranks all call with the same reads:
        the neighbour search splits into row bands over them, on
        mesh.device, and every rank returns the same result.
      device: "cuda" (the default: the kernels; raises without a card) or
        "cpu"; with a mesh, mesh.device (another device raises).
    Returns:
      (labels, molecules): `labels[i]` is the molecule id of read i;
      `molecules[m]` is `(insert_bytes, umi_bytes)` for molecule m (the
      highest-count UMI of its cluster).
    """
    _check_read_args(len_5p, len_3p, method)
    device = _dedup_device(device, mesh)
    if len(reads) == 0:
        return np.zeros(0, np.int64), []
    matrix = isinstance(reads, np.ndarray) and reads.ndim == 2
    if matrix:
        if reads.dtype != np.uint8:
            raise TypeError("array input must be a 2-D uint8 read matrix")
        mat, lengths = reads, np.full(len(reads), reads.shape[1], np.int64)
    else:
        mat, lengths = _padded_rows(reads)
    res = _dedup_reads_ragged(mat, lengths, len_5p, len_3p, method,
                              threshold, _block, device, mesh)
    if matrix:
        _dedup_reads_ragged.padded_reads += len(lengths)
    else:
        _dedup_reads_ragged.list_reads += len(lengths)
    return res


def dedup_fastq(filename, len_5p: int = 0, len_3p: int = 0,
                threshold: int = 1, method: str = "directional",
                device=None):
    """UMI read deduplication of a FASTQ file (plain or gzip): the path
    of `python -m shortseq_torch umi`.  The reads are read with
    io.fastq.read_fastq_matrix into one padded uint8 matrix and their
    lengths, which go as they are to `_dedup_reads_ragged`, with no
    per-read bytes object, and are counted on
    `_dedup_reads_ragged.padded_reads`.

    Returns (molecules, reads_per_molecule): `molecules[m]` is
    `(insert_bytes, umi_bytes)` as `dedup_reads` gives it, and
    `reads_per_molecule[m]` (int64) the number of reads of molecule m.
    Arguments and errors are `dedup_reads`'."""
    from ..io.fastq import read_fastq_matrix

    with named_scope("ssq.umi_dedup"):
        with named_scope("ssq.umi_read"):
            mat, lengths = read_fastq_matrix(filename, pad_to=1)
        _check_read_args(len_5p, len_3p, method)
        device = _dedup_device(device, None)
        if not len(lengths):
            return [], np.zeros(0, np.int64)
        labels, molecules = _dedup_reads_ragged(
            mat, lengths, len_5p, len_3p, method, threshold, None, device)
        _dedup_reads_ragged.padded_reads += len(lengths)
        with named_scope("ssq.umi_collapse"):
            reads_per_molecule = np.bincount(labels,
                                             minlength=len(molecules))
    return molecules, reads_per_molecule
