"""Streaming multi-shard / multi-rank FASTQ dedup pipeline, from
shortseq_tpu/dist/pipeline.py.

The file is split into byte-range shards (record-synced boundaries, the
native sharder csrc/fastq_index.cpp ssq_fastq_sync), each shard is packed
on the host and counted on the device in batches of at most
config.batch_size rows, the per-shard tables are optionally checkpointed
(count/checkpoint.py; resume = skip completed shards), and the final
table is one associative merge.

Multi-rank: rank h processes shards h, h+H, h+2H, ... and the per-rank
tables merge with one collective pass (count_sharded_auto).  Single-rank
runs do the same loop in-process, so the code path is identical.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, PipelineConfig
from ..count import checkpoint
from ..count.device import PAD_LENGTH


def _batched_count_tables(data, starts, lengths, config: PipelineConfig,
                          device):
    """Yield a device count table for each batch of one shard's indexed
    reads: one width bucket, at most config.batch_size rows.  Packing and
    bloom validation happen in the host gather (count/ingest.
    packed_buckets), so only 2-bit words cross to the device."""
    from ..api.counter import _put_lengths, _put_words
    from ..count.device import unique_count
    from ..count.ingest import packed_buckets

    for words, sub_len in packed_buckets(data, starts, lengths,
                                         batch_size=config.batch_size,
                                         pad_pow2=False):
        yield unique_count(_put_words(words, device),
                           _put_lengths(sub_len, device),
                           torch.ones(len(sub_len), dtype=torch.int32,
                                      device=device))


def count_fastq_sharded(filename, n_shards: int = 1, host: int = 0,
                        n_hosts: int = 1,
                        config: PipelineConfig = DEFAULT_CONFIG,
                        device="cuda"):
    """Count `filename`'s reads across byte-range shards; this rank
    processes shards host, host+n_hosts, ...  Returns the merged table of
    THIS rank's shards, (u_words, u_lengths, u_counts, n_unique) on
    `device` ("cuda" raises without a card; "cpu" runs the plain
    versions); merge across ranks with checkpoint.merge_tables or
    dist.count_sharded_auto.

    With config.checkpoint_dir set, each shard's table is spilled after
    counting and completed shards are skipped on resume.
    """
    from .. import _build
    from ..io.fastq import read_fastq_index
    from ..utils.warmup import start_transfer_warmup

    device = _build.resolve_device(device)
    start_transfer_warmup(device)
    size = os.path.getsize(filename)
    ckpt = config.checkpoint_dir
    done = set()
    if ckpt:
        # Refuse to resume with incompatible sharding, a different file,
        # or modified content (size alone misses same-size edits).
        checkpoint.check_manifest(
            ckpt, file=os.path.basename(str(filename)), size=size,
            n_shards=n_shards, n_hosts=n_hosts,
            fingerprint=checkpoint.file_fingerprint(filename))
        done = checkpoint.completed_shards(ckpt, host)

    tables = []  # host tables: freshly counted shards + resumed loads
    for shard in range(host, n_shards, n_hosts):
        if shard in done:
            tables.append(checkpoint.load_table(
                checkpoint.shard_path(ckpt, host, shard)))
            continue
        lo = shard * size // n_shards
        hi = (shard + 1) * size // n_shards
        # n_shards == 1 reads the whole file: no byte-range path, so
        # single-shard runs also accept plain gzip input.
        rng = (lo, hi) if n_shards > 1 else None
        data, starts, lengths = read_fastq_index(filename, byte_range=rng)
        # Fetch each batch table as it is produced: device memory stays
        # O(batch), not O(shard).
        host_tables = [_table_to_host(t) for t in _batched_count_tables(
            data, starts, lengths, config, device)]
        if ckpt:
            w, l, c = _table_to_host(
                _merge_host_tables(host_tables, device))
            checkpoint.save_table(checkpoint.shard_path(ckpt, host, shard),
                                  w, l, c, len(l))
            tables.append((w, l, c))
        else:
            tables.extend(host_tables)
    return _merge_host_tables(tables, device)


def _raise_if_poisoned(cnts) -> None:
    if len(cnts) and int(np.asarray(cnts).min()) < 0:
        raise OverflowError(
            "count table entry exceeded int32; merge in smaller pieces")


def _table_to_host(table):
    """A count table -> compact host (words uint32, lengths int32, counts
    int32), raising on n_out overflow and on int32-wrapped (poisoned,
    count < 0) entries: a poisoned count re-merged with more weight could
    land positive and pass every later check.

    Takes plain (w, l, c, n) prefix tables (tensors or host arrays) and
    ShardedCountTable; a "scattered" table gathers every rank's slab
    (_scattered_to_host), so all ranks return the same table."""
    from ..count.device import fetch_table
    from .count import ShardedCountTable

    if isinstance(table, ShardedCountTable) and table.layout == "scattered":
        w, lens, cnts = _scattered_to_host(table.words, table.lengths,
                                           table.counts, table.mesh)
        if len(cnts) != int(table.n_unique):
            raise ValueError(
                f"scattered table live rows ({len(cnts)}) disagree with "
                f"n_unique ({int(table.n_unique)})")
        _raise_if_poisoned(cnts)
        return w, lens, cnts
    u_words, u_lengths, u_counts, n_unique = table[:4]
    if isinstance(u_words, torch.Tensor):
        w, lens, cnts, _ = fetch_table(u_words, u_lengths, u_counts,
                                       n_unique)
    else:
        n = int(n_unique)
        lens = np.asarray(u_lengths)
        if n > len(lens):
            raise ValueError(
                f"count table overflow: {n} unique keys but only "
                f"{len(lens)} output rows (n_out too small)")
        w, lens, cnts = (np.asarray(u_words)[:n], lens[:n],
                         np.asarray(u_counts)[:n])
    _raise_if_poisoned(cnts)
    return w, lens, cnts


def _gather_padded(mesh, x: torch.Tensor, fill) -> torch.Tensor:
    """Every rank's `x` (row counts may differ), concatenated in rank
    order: each is padded with `fill` rows to the largest count, gathered,
    and the pad rows are cut out again."""
    from .count import _all_gather

    dev = mesh.device
    n = torch.tensor([x.shape[0]], dtype=torch.int64, device=dev)
    sizes = _all_gather(mesh, n).tolist()
    rows = max(sizes)
    pad = torch.full((rows - x.shape[0], *x.shape[1:]), fill,
                     dtype=x.dtype, device=dev)
    g = _all_gather(mesh, torch.cat([x.to(dev), pad]))
    return torch.cat([g[r * rows:r * rows + s] for r, s in enumerate(sizes)])


def _scattered_to_host(words, lengths, counts, mesh=None):
    """Host arrays of a scattered-layout table's live rows.  This rank's
    slab is filtered on PAD_LENGTH; over a grouped mesh the slabs of all
    ranks (disjoint keys, final counts) are gathered in rank order, so
    every rank returns the identical full table."""
    keep = lengths != PAD_LENGTH
    w, l, c = words[keep], lengths[keep], counts[keep]
    if mesh is not None and mesh.distributed:
        w = _gather_padded(mesh, w, 0)
        l = _gather_padded(mesh, l, PAD_LENGTH)
        c = _gather_padded(mesh, c, 0)
    return (w.cpu().numpy().view(np.uint32), l.cpu().numpy(),
            c.cpu().numpy())


def gather_row_sharded(x, mesh=None) -> np.ndarray:
    """Host numpy of a row-sharded result in global row order: each rank
    holds its own band of rows (bands may differ in length), and the
    bands are gathered in rank order.  Without a grouped mesh, x itself."""
    if isinstance(x, torch.Tensor):
        if mesh is not None and mesh.distributed:
            x = _gather_padded(mesh, x, 0)
        return x.cpu().numpy()
    return np.asarray(x)


def table_to_host_rows(table):
    """Materialize any count table (prefix or scattered, one rank or many)
    as [((length, blocks64 tuple), count), ...] host rows - the
    layout-agnostic consumption path for merged tables."""
    from ..count.device import _rows_to_table

    return _rows_to_table(*_table_to_host(table))


def _merge_host_tables(tables, device):
    """Concat + one unique_count on `device` (count/checkpoint.py owns the
    shared implementation); an empty list is the canonical empty table."""
    if not tables:
        from ..count.device import empty_table

        return empty_table(1, device)
    return checkpoint.merge_host_tuples(tables, device=device)


def read_and_count_fastq_distributed(filename, n_shards: int | None = None,
                                     config: PipelineConfig = DEFAULT_CONFIG,
                                     device="cuda"):
    """Multi-rank entry point: every rank calls this with the same
    filename; rank h parses and counts its byte-range shards locally
    (count_fastq_sharded), then the per-rank tables are merged exactly
    with one collective pass over the `data` mesh (count_sharded_auto:
    the bucketed exchange, with the exact gather as its fallback).  The
    process group comes from initialize_distributed (torchrun's
    environment, or one started by the caller).  Returns a
    ShardedCountTable; consume it with table_to_counter /
    table_to_host_rows, which handle both layouts on every rank.

    A single rank returns its count_fastq_sharded table as a "prefix"
    table with no merge, so this is also the simplest correct entry point
    everywhere."""
    from .count import ShardedCountTable, _all_gather, count_sharded_auto
    from .mesh import data_mesh, initialize_distributed

    initialize_distributed(device=device)
    mesh = data_mesh(device=device)
    host, n_hosts = mesh.rank, mesh.size
    if n_shards is None:
        n_shards = max(1, n_hosts)
    local = count_fastq_sharded(filename, n_shards=n_shards, host=host,
                                n_hosts=n_hosts, config=config,
                                device=mesh.device)
    if n_hosts == 1:
        return ShardedCountTable(*local, "prefix")

    w, l, c = _table_to_host(local)
    # Agree on a common row count (tables differ per rank) and a common
    # lane width, then each rank contributes its padded slab.
    mine = torch.tensor([len(l), w.shape[1] if w.size else 1],
                        dtype=torch.int64, device=mesh.device)
    sizes = _all_gather(mesh, mine).reshape(-1, 2)
    rows, width = (int(v) for v in sizes.max(dim=0).values.tolist())
    w_pad = np.zeros((rows, width), np.uint32)
    l_pad = np.full(rows, PAD_LENGTH, np.int32)
    c_pad = np.zeros(rows, np.int32)
    w_pad[:len(l), :w.shape[1]] = w
    l_pad[:len(l)] = l
    c_pad[:len(l)] = c
    from ..api.counter import _put_words

    return count_sharded_auto(mesh)(_put_words(w_pad, mesh.device),
                                    torch.from_numpy(l_pad).to(mesh.device),
                                    torch.from_numpy(c_pad).to(mesh.device))


def table_to_counter(table):
    """Merged table -> reference-identical ShortSeqCounter (one native
    call for the whole table, api.counter.update_counter_from_host_table).
    Routes through _table_to_host, so an n_out-too-small table raises the
    overflow error instead of silently dropping keys, and scattered
    layouts gather every rank's slab."""
    from ..api.counter import ShortSeqCounter, update_counter_from_host_table

    out = ShortSeqCounter()
    w, l, c = _table_to_host(table)
    update_counter_from_host_table(out, w, l, c)
    return out
