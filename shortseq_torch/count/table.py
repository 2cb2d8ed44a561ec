"""Lazy count-table handle: Counter-style reads without materialization,
from shortseq_tpu/count/table.py.

CountTable keeps the deduplicated table where the engine produced it - as
tensors on the count's device (live-prefix contract from
count.device.unique_count) or host numpy arrays (compact, from
io.native.host_count_native) - one table per width bucket, each at its
OWN lane width, and answers:

  len(t)            number of unique sequences (one scalar fetch per bucket)
  t.total()         total read count (a sum on the bucket's device)
  t.most_common(n)  top-n by count: a stable descending sort on the
                    bucket's device -> fetch n rows -> materialize n
                    objects (not the whole table)
  key in t / t[key] pack the query on host, one equality scan per
                    matching bucket on its device
  t.to_counter()    full reference-identical ShortSeqCounter

The JAX package's jitted reads (_topk_rows_jit, _lookup_jit, _total_jit)
are plain torch functions here (_topk_rows, _lookup, _total).  Ordering of
ties in most_common is deterministic by (count desc, then key asc), and
lookups are sequence-keyed (ShortSeq / str / bytes all name the same key).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import scoped
from .device import d2h, h2d

_INT32_MAX = 2**31 - 1


class _Bucket:
    """One width-class table.  Tensor buckets hold padded tables with the
    live-prefix contract (rows [0, n_unique) live, padding after); host
    buckets hold compact numpy arrays."""

    __slots__ = ("words", "lengths", "counts", "_n", "device")

    def __init__(self, words, lengths, counts, n_unique, device: bool):
        self.words = words
        self.lengths = lengths
        self.counts = counts
        self._n = n_unique  # int for host; 0-d tensor until first read
        self.device = device

    @property
    def n_unique(self) -> int:
        if not isinstance(self._n, int):
            self._n = int(d2h(self._n))
        return self._n

    @property
    def width(self) -> int:
        return self.words.shape[1]


def _pairs_from_rows(w, lens, cnts):
    """Host table rows -> [(ShortSeq, int), ...] (n objects, not the
    whole table)."""
    from .. import api
    from .device import _rows_to_table

    return [(api.from_blocks(blocks, length), count)
            for (length, blocks), count in _rows_to_table(w, lens, cnts)]


def _topk_rows(words, lengths, counts, k: int):
    """The k rows of largest count, ties to the lower index first (the
    order of lax.top_k: torch.topk promises none among ties), and the
    minimum over ALL counts: a poisoned (-1) entry is by definition the
    largest true count and would never surface in the top k, so the
    caller must raise on it."""
    _topk_rows.calls += 1
    idx = torch.sort(counts, descending=True, stable=True).indices[:k]
    return words[idx], lengths[idx], counts[idx], counts.min()


def _lookup(words, lengths, counts, q_words, q_len: int):
    """Sum of the counts of rows equal to the query key (at most one)."""
    _lookup.calls += 1
    hit = (lengths == q_len) & (words == q_words[None, :]).all(dim=1)
    return torch.where(hit, counts, 0).sum()


def _total(counts):
    """Sum of all counts (padding rows carry 0), or -1 when it leaves the
    int32 range or an entry is already poisoned (-1): the JAX package's
    int32 total with its shadow-sum wrap check, summed exactly in int64."""
    _total.calls += 1
    s = counts.sum(dtype=torch.int64)
    return torch.where((s > _INT32_MAX) | (counts.min() < 0), -1, s)


# Calls of K8's reads (torch ops, not hand kernels), counted as the hand
# kernels' wrappers count their launches.
_topk_rows.calls = _lookup.calls = _total.calls = 0


def _key_to_rows(key):
    """A lookup key (ShortSeq / str / bytes) -> (length, lanes list) in the
    repo's uint32 lane layout, or None for non-sequence types."""
    from .. import api
    from ..oracle import blocks_to_lanes, encode_bytes

    b = None
    if isinstance(key, str):
        b = key.encode("ascii", "replace")
    elif isinstance(key, (bytes, bytearray)):
        b = bytes(key)
    elif isinstance(key, (api.ShortSeq64, api.ShortSeq192, api.ShortSeqVar)):
        b = str(key).encode("ascii")
    if b is None:
        return None
    try:
        blocks = encode_bytes(b)
    except Exception:
        return None  # invalid bases can never be table keys
    return len(b), blocks_to_lanes(blocks, 2 * max(1, len(blocks)))


def _raise_poisoned():
    raise OverflowError(
        "count table entry exceeded int32; merge in smaller pieces")


class CountTable:
    """Lazy, bucketed count table (see module docstring).  Build with the
    engine helpers (api.counter.read_and_count_fastq_table) or from_merged
    for distributed results."""

    def __init__(self, buckets):
        self._buckets = list(buckets)

    # -- construction -------------------------------------------------

    @classmethod
    def from_device_tables(cls, tables):
        """tables: iterable of unique_count results (padded live-prefix
        tensors)."""
        return cls(_Bucket(w, l, c, n, device=True)
                   for w, l, c, n in tables)

    @classmethod
    def from_host_tables(cls, tables):
        """tables: iterable of compact host (words, lengths, counts)."""
        return cls(_Bucket(np.asarray(w), np.asarray(l), np.asarray(c),
                           len(np.asarray(l)), device=False)
                   for w, l, c in tables)

    @classmethod
    def from_merged(cls, table):
        """A merged distributed table (ShardedCountTable or plain 4-tuple,
        any layout) -> single-bucket CountTable on host arrays."""
        from ..dist.pipeline import _table_to_host

        return cls.from_host_tables([_table_to_host(table)])

    # -- cheap reads ---------------------------------------------------

    def __len__(self) -> int:
        return sum(b.n_unique for b in self._buckets)

    @scoped("ssq.table_read")
    def total(self) -> int:
        """Total read count (sum of all counts) without materialization."""
        total = 0
        for b in self._buckets:
            if b.device:
                s = int(d2h(_total(b.counts)))
                if s < 0:
                    raise OverflowError(
                        "count total exceeded int32; use to_counter()")
                total += s
            else:
                cnts = np.asarray(b.counts, np.int64)
                if cnts.size and int(cnts.min()) < 0:
                    raise OverflowError(
                        "count table entry exceeded int32; use smaller "
                        "merges")
                total += int(cnts.sum())
        return total

    @scoped("ssq.table_read")
    def most_common(self, n: int | None = None):
        """Top-n (ShortSeq, count) pairs by count desc (ties: key asc).
        Fetches and materializes only n rows per bucket; n=None returns
        the full table sorted.

        Which members of a tie at the n-th-count boundary surface depends
        on the engine's table order (host hash order vs device sort
        order); entries with counts strictly above the boundary are always
        identical across engines."""
        from .device import fetch_table

        rows = []
        for b in self._buckets:
            live = b.n_unique
            if live == 0:
                continue
            if n is None or not b.device:
                if b.device:
                    w, lens, cnts, _ = fetch_table(b.words, b.lengths,
                                                   b.counts, b._n)
                else:
                    w, lens, cnts = (np.asarray(b.words)[:live],
                                     np.asarray(b.lengths)[:live],
                                     np.asarray(b.counts)[:live])
                if len(cnts) and int(np.asarray(cnts).min()) < 0:
                    # Check BEFORE top-n selection: the partition would
                    # drop a poisoned (-1) row - the table's true maximum.
                    _raise_poisoned()
                if n is not None and n < len(cnts):
                    # host top-n: argpartition, no full sort
                    part = np.argpartition(-cnts, n - 1)[:n]
                    w, lens, cnts = w[part], lens[part], cnts[part]
            else:
                k = min(b.words.shape[0], n)
                w, lens, cnts, min_count = _topk_rows(b.words, b.lengths,
                                                      b.counts, k)
                if int(d2h(min_count)) < 0:
                    _raise_poisoned()
                w = d2h(w).numpy().view(np.uint32)
                lens, cnts = d2h(lens).numpy(), d2h(cnts).numpy()
                keep = cnts > 0  # k > live rows pulls in zero-count padding
                w, lens, cnts = w[keep], lens[keep], cnts[keep]
            rows.extend(_pairs_from_rows(w, lens, cnts))
        # count desc, then key asc (decoded string order, not block order)
        rows.sort(key=lambda kv: (-kv[1], str(kv[0])))
        return rows if n is None else rows[:n]

    @scoped("ssq.table_read")
    def values(self):
        """All live counts as a host numpy int64 array (order
        unspecified), without materializing a single key object.  Raises
        on poisoned entries like every other read."""
        out = []
        for b in self._buckets:
            n = b.n_unique
            if n == 0:
                continue
            if n > b.counts.shape[0]:
                raise ValueError(
                    f"count table overflow: {n} unique keys but only "
                    f"{b.counts.shape[0]} output rows (n_out too small)")
            if b.device:
                cnts = d2h(b.counts[:n]).numpy()
            else:
                cnts = np.asarray(b.counts)[:n]
            cnts = np.asarray(cnts, np.int64)
            if cnts.size and int(cnts.min()) < 0:
                _raise_poisoned()
            out.append(cnts)
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    # -- lookups --------------------------------------------------------

    @scoped("ssq.table_read")
    def get(self, key, default=0):
        return self._get(key, default)

    def _get(self, key, default):
        from ..ops.lanes import from_numpy_u32

        q = _key_to_rows(key)
        if q is None:
            return default
        q_len, lanes = q
        total = 0
        found = False
        for b in self._buckets:
            if b.n_unique == 0:
                continue
            width = b.width
            if q_len > 16 * width:
                continue  # key cannot fit this bucket's lanes
            q_words = np.zeros(width, np.uint32)
            q_words[:min(len(lanes), width)] = lanes[:width]
            if any(int(x) for x in lanes[width:]):
                continue  # key has live lanes beyond this bucket's width
            if b.device:
                c = int(d2h(_lookup(b.words, b.lengths, b.counts,
                                    h2d(from_numpy_u32(q_words),
                                        b.words.device),
                                    q_len)))
            else:
                hit = (np.asarray(b.lengths) == q_len) & (
                    np.asarray(b.words) == q_words[None, :]).all(axis=1)
                c = int(np.asarray(b.counts)[hit].sum())
            if c < 0:
                _raise_poisoned()
            if c:
                total += c
                found = True
        return total if found else default

    @scoped("ssq.table_read")
    def __contains__(self, key) -> bool:
        return self._get(key, None) is not None

    @scoped("ssq.table_read")
    def __getitem__(self, key) -> int:
        c = self._get(key, None)
        if c is None:
            raise KeyError(key)
        return c

    # -- materialization -------------------------------------------------

    @scoped("ssq.to_counter")
    def to_counter(self):
        """Full reference-identical ShortSeqCounter (materializes every
        unique sequence as a Python object - the expensive path this
        class exists to avoid for partial reads)."""
        from ..api.counter import (ShortSeqCounter,
                                   update_counter_from_host_table)
        from .device import fetch_table

        out = ShortSeqCounter()
        for b in self._buckets:
            if b.device:
                w, lens, cnts, _ = fetch_table(b.words, b.lengths, b.counts,
                                               b._n)
            else:
                live = b.n_unique
                w, lens, cnts = (np.asarray(b.words)[:live],
                                 np.asarray(b.lengths)[:live],
                                 np.asarray(b.counts)[:live])
            update_counter_from_host_table(out, w, lens, cnts)
        return out
