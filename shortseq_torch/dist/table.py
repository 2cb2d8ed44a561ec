"""Lazy reads over a mesh-SHARDED count table, from
shortseq_tpu/dist/table.py.

count.table.CountTable gives single-device tables Counter-style reads
without materialization; this is the same contract for the production
merge's output (count_sharded_auto, layout="scattered": rank d holds the
uniques of hash bucket d, rows PAD-interleaved).  Without it, a
multi-rank `top 20` would pull the ENTIRE table to every rank just to
discard all but 20 rows.

Every rank calls each read together; each read runs collectives and
returns the same answer on every rank:

  len(t)           n_unique (already summed over the ranks)
  t.total()        an all_reduce of the sums (padding counts are 0)
  t.most_common(n) a per-rank top-k -> all_gather of D*k candidate rows
                   -> host merge of D*k rows, never the table; an
                   all_reduce MIN catches a poisoned count
  key in t / t[k]  a per-rank comparison scan -> all_reduce -> a scalar
  t.values()       each rank's live counts, gathered
  t.to_counter()   full materialization via dist.pipeline.table_to_counter

Prefix-layout tables (the fallback's replicated output) need none of
this: distributed_count_table() routes them to the plain CountTable.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..count.table import _INT32_MAX, _raise_poisoned

def distributed_count_table(table, mesh):
    """The right lazy view for a merged table: plain CountTable for
    prefix layouts (and plain 4-tuples), DistributedCountTable for
    scattered layouts."""
    from ..count.table import CountTable
    from .count import ShardedCountTable

    if not isinstance(table, ShardedCountTable) or table.layout == "prefix":
        return CountTable.from_device_tables([tuple(table[:4])])
    return DistributedCountTable(table, mesh)


def _topk_step(mesh, k: int):
    """This rank's k largest counts (ties to the lower row, as lax.top_k)
    and their rows, gathered from every rank in rank order, plus the
    minimum count over all ranks."""
    from ..count.table import _topk_rows
    from .count import _all_gather, _all_reduce

    def step(words, lengths, counts):
        w, l, v, mn = _topk_rows(words, lengths, counts, k)
        return (_all_gather(mesh, w), _all_gather(mesh, l),
                _all_gather(mesh, v),
                _all_reduce(mesh, mn, dist.ReduceOp.MIN))

    return step


class DistributedCountTable:
    def __init__(self, table, mesh):
        from .count import ShardedCountTable

        if not (isinstance(table, ShardedCountTable)
                and table.layout == "scattered"):
            raise ValueError("expected a scattered-layout ShardedCountTable")
        self._t = table
        self._mesh = mesh
        self._n = None

    # -- cheap reads ----------------------------------------------------

    def __len__(self) -> int:
        if self._n is None:
            self._n = int(self._t.n_unique)
        return self._n

    def total(self) -> int:
        from .count import _all_reduce

        c = self._t.counts
        s = _all_reduce(self._mesh, c.sum(dtype=torch.int64),
                        dist.ReduceOp.SUM)
        mn = _all_reduce(self._mesh, c.min() if c.numel() else
                         torch.zeros((), dtype=c.dtype, device=c.device),
                         dist.ReduceOp.MIN)
        s = int(s)
        if s > _INT32_MAX or int(mn) < 0:
            raise OverflowError(
                "count table entry/total exceeded int32; merge in smaller "
                "pieces")
        return s

    def most_common(self, n: int | None = None):
        """Top-n (ShortSeq, count) pairs, count desc then key asc.  Only
        D*k candidate rows cross the mesh and reach the host (k = n
        rounded up to a power of two, at least 16); n=None materializes
        the whole table.  Tie members at the boundary follow rank order
        (the same freedom CountTable.most_common documents)."""
        from ..count.table import _pairs_from_rows

        if n is None:
            from .pipeline import _table_to_host

            rows = _pairs_from_rows(*_table_to_host(self._t))
            rows.sort(key=lambda kv: (-kv[1], str(kv[0])))
            return rows
        k = max(16, 1 << max(n - 1, 0).bit_length())
        k = max(1, min(k, self._t.counts.shape[0]))
        w, lens, cnts, mn = _topk_step(self._mesh, k)(
            self._t.words, self._t.lengths, self._t.counts)
        if int(mn) < 0:
            _raise_poisoned()
        w = w.cpu().numpy().view(np.uint32)
        lens, cnts = lens.cpu().numpy(), cnts.cpu().numpy()
        keep = cnts > 0  # pad rows carry count 0
        rows = _pairs_from_rows(w[keep], lens[keep], cnts[keep])
        rows.sort(key=lambda kv: (-kv[1], str(kv[0])))
        return rows[:n]

    def values(self):
        """All live counts as host numpy int64 (order unspecified); every
        rank returns the same multiset.  Only counts cross the mesh, never
        the words, and the live row count is checked against n_unique."""
        from ..count.device import PAD_LENGTH
        from .pipeline import _gather_padded

        cnts = self._t.counts[self._t.lengths != PAD_LENGTH]
        if self._mesh.distributed:
            cnts = _gather_padded(self._mesh, cnts, 0)
        cnts = cnts.cpu().numpy().astype(np.int64)
        if len(cnts) != len(self):
            raise ValueError(
                f"scattered table live rows ({len(cnts)}) disagree with "
                f"n_unique ({len(self)})")
        if cnts.size and int(cnts.min()) < 0:
            _raise_poisoned()
        return cnts

    # -- lookups ----------------------------------------------------------

    def get(self, key, default=0):
        from ..count.table import _key_to_rows, _lookup
        from ..ops.lanes import from_numpy_u32
        from .count import _all_reduce

        q = _key_to_rows(key)
        if q is None:
            return default
        q_len, lanes = q
        width = self._t.words.shape[1]
        if q_len > 16 * width or any(int(x) for x in lanes[width:]):
            return default
        q_words = np.zeros(width, np.uint32)
        q_words[:min(len(lanes), width)] = lanes[:width]
        c = _lookup(self._t.words, self._t.lengths, self._t.counts,
                    from_numpy_u32(q_words).to(self._t.words.device), q_len)
        c = int(_all_reduce(self._mesh, c, dist.ReduceOp.SUM))
        if c < 0:
            _raise_poisoned()
        return c if c else default

    def __contains__(self, key) -> bool:
        return self.get(key, None) is not None

    def __getitem__(self, key) -> int:
        c = self.get(key, None)
        if c is None:
            raise KeyError(key)
        return c

    # -- materialization --------------------------------------------------

    def to_counter(self):
        from .pipeline import table_to_counter

        return table_to_counter(self._t)

