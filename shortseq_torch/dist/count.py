"""Sharded dedup: per-rank sort-unique count + collective merge, from
shortseq_tpu/dist/count.py.

Each rank counts its rows locally (count/device.unique_count), and the
tables merge exactly because counting is associative:

  * count_sharded: all_gather every rank's table, then one more
    unique_count (replicated, "prefix" layout; per-rank work grows with
    the world size);
  * count_sharded_bucketed: rows go to the rank that owns their hash
    bucket (K10, csrc/dist.cu, then all_to_all_single), so each rank
    dedups a DISJOINT key range ("scattered" layout; per-rank work flat in
    the world size), with an overflow flag when a bucket exceeds its
    capacity;
  * count_sharded_auto: the bucketed exchange, then the same with a local
    pre-dedup, then count_sharded, each tier taken only when the
    all-reduced flag says the one before overflowed, so every rank takes
    the same tier.

Every function takes THIS rank's rows; all ranks call it together with
the same row count and lane width (the shard_map contract of the JAX
package, checked here with one small all_reduce).  On a mesh of one
ungrouped process every collective is the identity.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import _build
from ..count.device import PAD_LENGTH, unique_count

_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF


class ShardedCountTable(NamedTuple):
    """A merged count table plus the layout contract its consumers need.

    layout:
      "prefix"    - live rows form a contiguous [0, n_unique) prefix and
                    every rank holds the whole table (count_sharded's
                    contract); safe for fetch_table / CountTable.
      "scattered" - this rank's slab of a table spread over the mesh:
                    live rows are PAD-interleaved and each rank holds the
                    disjoint keys of its buckets; materialize with
                    dist.pipeline.table_to_host_rows / table_to_counter,
                    which gather the slabs of every rank.
    n_unique is the table's total over all ranks in both layouts.
    mesh: the DataMesh a scattered table's slabs live on (None: this
    process holds the whole table).
    """

    words: torch.Tensor
    lengths: torch.Tensor
    counts: torch.Tensor
    n_unique: torch.Tensor
    layout: str
    mesh: object = None


# -- collectives (identity on an ungrouped mesh) ----------------------------


def _all_gather(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's equal-shaped `x`, concatenated in rank order on dim 0."""
    if not mesh.distributed:
        return x
    out = torch.empty((mesh.size * x.shape[0], *x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    gather(out, x.contiguous(), group=mesh.group)
    return out


def _all_to_all(mesh, x: torch.Tensor) -> torch.Tensor:
    """Chunk r of dim 0 goes to rank r; chunk r of the result came from
    rank r (equal chunks)."""
    if not mesh.distributed:
        return x
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=mesh.group)
    return out


def _all_reduce(mesh, x: torch.Tensor, op) -> torch.Tensor:
    if mesh.distributed:
        x = x.clone()
        dist.all_reduce(x, op=op, group=mesh.group)
    return x


def _check_same_shape(mesh, words: torch.Tensor) -> None:
    """Raise on every rank unless all ranks hold the same [n, W]: the
    equal splits of the exchange and the gather need it, and a mismatch
    would otherwise hang a collective."""
    if not mesh.distributed:
        return
    n, w = words.shape
    shape = torch.tensor([n, w, -n, -w], dtype=torch.int64,
                         device=words.device)
    dist.all_reduce(shape, op=dist.ReduceOp.MAX, group=mesh.group)
    hi_n, hi_w, lo_n, lo_w = (int(v) for v in shape.tolist())
    if (hi_n, hi_w) != (-lo_n, -lo_w):
        raise ValueError(
            f"ranks disagree on the shard shape: rows {-lo_n}..{hi_n}, "
            f"lanes {-lo_w}..{hi_w}; pad every rank to the same [n, W]")


# -- K10: bucket ids and send buffers --------------------------------------


def _check_buckets(n_buckets: int) -> None:
    if not (0 < n_buckets <= 1 << 16):
        raise ValueError(f"n_buckets must be in [1, 65536], got {n_buckets}")


def _bucket_hash(words: torch.Tensor, lengths: torch.Tensor,
                 n_buckets: int) -> torch.Tensor:
    """Bucket id (int64 [N]) of every row, PAD rows included: a Fibonacci
    multiplicative hash of the XOR of the lanes and the length, then a
    multiply-shift range map of its top 16 bits, bucket = (h >> 16) * D
    >> 16 (equal-width ranges for any D, not only powers of two).  uint32
    arithmetic in int64 with & 0xFFFFFFFF: the lanes' bits are widened
    unsigned, and the product mod 2^32 is taken in 16-bit halves so that
    no intermediate leaves int64."""
    _check_buckets(n_buckets)
    h = lengths.long() & _U32
    for j in range(words.shape[1]):
        h = h ^ (words[:, j].long() & _U32)
    lo = (h & 0xFFFF) * _HASH_MUL
    hi = (((h >> 16) * _HASH_MUL) & 0xFFFF) << 16
    h = (lo + hi) & _U32
    return ((h >> 16) * n_buckets) >> 16


def bucket_capacity(n: int, n_buckets: int, capacity_factor: float) -> int:
    """Rows each bucket of an n-row shard may send: the mean load times
    the factor (hash skew at scale), plus 16 (small-shard balls-in-bins
    variance), at most n; computed in Python floats as the JAX package
    does."""
    return min(n, int(np.ceil(n / n_buckets * capacity_factor)) + 16)


def bucket_send_buffers_plain(words, lengths, weights, n_buckets: int,
                              cap: int):
    """Plain PyTorch version of K10: a stable sort by bucket (PAD rows to
    the virtual bucket D), each row's rank in its bucket by searchsorted,
    and scatters into [D * cap] buffers.  Returns (send_words [D*cap, W],
    send_lengths [D*cap], send_weights [D*cap], overflow int32 0-d)."""
    _check_buckets(n_buckets)
    n, w = words.shape
    dev = words.device
    d = n_buckets
    bucket = torch.where(lengths != PAD_LENGTH,
                         _bucket_hash(words, lengths, d), d)
    order = torch.sort(bucket, stable=True).indices
    s_bucket = bucket[order]
    first = torch.searchsorted(s_bucket, torch.arange(d, device=dev))
    rank = torch.arange(n, device=dev) - first[s_bucket.clamp(max=d - 1)]
    s_live = s_bucket < d
    overflow = (s_live & (rank >= cap)).any().to(torch.int32)
    # Dropped rows (PAD, or past capacity) land in one extra row, cut off.
    dest = torch.where(s_live & (rank < cap), s_bucket * cap + rank, d * cap)
    send_words = torch.zeros((d * cap + 1, w), dtype=torch.int32, device=dev)
    send_lengths = torch.full((d * cap + 1,), PAD_LENGTH, dtype=torch.int32,
                              device=dev)
    send_weights = torch.zeros(d * cap + 1, dtype=torch.int32, device=dev)
    send_words[dest] = words[order]
    send_lengths[dest] = lengths[order]
    send_weights[dest] = weights[order]
    return (send_words[:d * cap], send_lengths[:d * cap],
            send_weights[:d * cap], overflow)


#: Most ints of K10's per-(bucket, tile) histogram: tiles grow past
#: BUCKET_TILE_ROWS rows when D * tiles would exceed it.
_HISTOGRAM_INTS = 1 << 26
BUCKET_TILE_ROWS = 1024


def bucket_send_buffers(words, lengths, weights, n_buckets: int, cap: int):
    """K10 (csrc/dist.cu): the bucketed exchange's send buffers, as
    bucket_send_buffers_plain computes them (three launches, counted as
    one).  A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version."""
    _check_buckets(n_buckets)
    if words.device.type == "cpu":
        return bucket_send_buffers_plain(words, lengths, weights, n_buckets,
                                         cap)
    dev = words.device
    _build.check_operand(words, "words", torch.int32, 2, dev)
    n, w = words.shape
    for name, t in (("lengths", lengths), ("weights", weights)):
        _build.check_operand(t, name, torch.int32, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, words has {n}")
    if n >= 2**31 or not 0 <= cap <= n:
        raise ValueError(f"K10 takes n < 2^31 rows and 0 <= cap <= n, got "
                         f"n {n}, cap {cap}")
    d = n_buckets
    send_words = torch.empty((d * cap, w), dtype=torch.int32, device=dev)
    send_lengths = torch.empty(d * cap, dtype=torch.int32, device=dev)
    send_weights = torch.empty(d * cap, dtype=torch.int32, device=dev)
    overflow = torch.zeros((), dtype=torch.int32, device=dev)
    if n == 0:
        return send_words, send_lengths, send_weights, overflow
    tile_rows = BUCKET_TILE_ROWS
    while d * -(-n // tile_rows) > _HISTOGRAM_INTS:
        tile_rows *= 2
    n_tiles = -(-n // tile_rows)
    bucket = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(d * n_tiles, dtype=torch.int32, device=dev)
    totals = torch.empty(d, dtype=torch.int32, device=dev)
    _build.launch("ssq_bucket_send", words.data_ptr(), lengths.data_ptr(),
                  weights.data_ptr(), bucket.data_ptr(), rank.data_ptr(),
                  counts.data_ptr(), totals.data_ptr(), send_words.data_ptr(),
                  send_lengths.data_ptr(), send_weights.data_ptr(),
                  overflow.data_ptr(), n, w, d, cap, tile_rows, n_tiles)
    bucket_send_buffers.launches += 1
    return send_words, send_lengths, send_weights, overflow


bucket_send_buffers.launches = 0


# -- merges -----------------------------------------------------------------


def count_sharded(mesh):
    """Exact merge by gathering: (words [n, W], lengths [n], weights [n])
    of this rank -> (u_words, u_lengths, u_counts, n_unique), the merged
    table on every rank, live rows a prefix of its n * size rows."""

    def run(words, lengths, weights):
        _check_same_shape(mesh, words)
        u_w, u_l, u_c, _ = unique_count(words, lengths, weights)
        return unique_count(_all_gather(mesh, u_w), _all_gather(mesh, u_l),
                            _all_gather(mesh, u_c))

    return run


def count_sharded_bucketed(mesh, capacity_factor: float = 2.0,
                           replicate: bool = True, pre_dedup: bool = False):
    """Scalable exact merge: each row goes to the rank of its hash bucket
    (K10 + all_to_all_single), so each rank dedups a disjoint key range.
    Returns a callable (words [n, W], lengths [n], weights [n]) ->
    (u_words, u_lengths, u_counts, n_unique, overflow), n_unique summed
    and overflow (int32 0/1) maxed over the ranks.  When overflow is 1 a
    bucket exceeded its capacity bucket_capacity(n, size,
    capacity_factor) on some rank and the table is incomplete: the caller
    discards it (count_sharded_auto falls back).

    pre_dedup=True counts the rows locally first, so a dominant key sends
    at most one row per rank.  replicate=False leaves this rank's slab
    (rows PAD-interleaved); replicate=True all_gathers the slabs and
    moves live rows to a prefix with one stable sort on the pad flag."""
    d = mesh.size

    def run(words, lengths, weights):
        _check_same_shape(mesh, words)
        if pre_dedup:
            # Shapes are unchanged: the table stays n rows, PAD-padded,
            # and the exchange drops PAD rows.
            words, lengths, weights, _ = unique_count(words, lengths,
                                                      weights)
        cap = bucket_capacity(words.shape[0], d, capacity_factor)
        s_w, s_l, s_c, overflow = bucket_send_buffers(words, lengths,
                                                      weights, d, cap)
        u_w, u_l, u_c, n_u = unique_count(_all_to_all(mesh, s_w),
                                          _all_to_all(mesh, s_l),
                                          _all_to_all(mesh, s_c))
        total = _all_reduce(mesh, n_u, dist.ReduceOp.SUM)
        overflow = _all_reduce(mesh, overflow, dist.ReduceOp.MAX)
        if not replicate:
            return u_w, u_l, u_c, total, overflow
        g_w, g_l, g_c = (_all_gather(mesh, x) for x in (u_w, u_l, u_c))
        perm = torch.sort((g_l == PAD_LENGTH).to(torch.int32),
                          stable=True).indices
        return g_w[perm], g_l[perm], g_c[perm], total, overflow

    return run


def count_sharded_auto(mesh, capacity_factor: float = 2.0):
    """The production merge: the bucketed exchange, then two exact
    fallback tiers on overflow.  Tier 1 is count_sharded_bucketed
    (replicate=False); on overflow tier 2 reruns it with a local
    pre-dedup (a duplicate-heavy shard collapses its dominant keys); if
    that overflows too (distinct-key hash skew), tier 3 runs
    count_sharded, which is always exact.  The flags are all-reduced, so
    every rank takes the same tier.

    Returns a callable (words, lengths, weights) -> ShardedCountTable:
    "scattered" from tiers 1-2, "prefix" from tier 3.  Each call adds one
    to count_sharded_auto.tiers[tier] for the tier it returns."""
    tiers = (count_sharded_bucketed(mesh, capacity_factor, replicate=False),
             count_sharded_bucketed(mesh, capacity_factor, replicate=False,
                                    pre_dedup=True))
    gather = count_sharded(mesh)

    def run(words, lengths, weights) -> ShardedCountTable:
        for tier, step in enumerate(tiers, 1):
            u_w, u_l, u_c, n_u, overflow = step(words, lengths, weights)
            if not int(overflow):
                count_sharded_auto.tiers[tier] += 1
                return ShardedCountTable(u_w, u_l, u_c, n_u, "scattered",
                                         mesh)
        count_sharded_auto.tiers[3] += 1
        return ShardedCountTable(*gather(words, lengths, weights), "prefix")

    return run


count_sharded_auto.tiers = {1: 0, 2: 0, 3: 0}


def make_sharded_counter(mesh, capacity_factor: float = 2.0):
    """The device pipeline of a rank: ASCII rows -> kernel A (pack +
    validate) -> count_sharded_auto.  Returns step(ascii_u8 [n, L] (numpy
    or tensor, L % 16 == 0, zero-padded), lengths [n]) ->
    (ShardedCountTable, ok [n * size] bool): every rank's validity mask in
    rank order, so any rank can raise the reference's "Unsupported base
    character" error with the offending read's global index.  The merge
    is built once here, not per call."""
    from ..ops.bitpack import pack_and_validate_u32

    counter = count_sharded_auto(mesh, capacity_factor)

    def step(ascii_u8, lengths):
        x = torch.as_tensor(np.asarray(ascii_u8, np.uint8)) \
            if not isinstance(ascii_u8, torch.Tensor) else ascii_u8
        n, width = x.shape
        if width % 16:
            raise ValueError(f"row width {width} is not a multiple of 16")
        x = x.to(mesh.device).contiguous().view(torch.int32)
        lens = torch.as_tensor(np.asarray(lengths, np.int32)) \
            if not isinstance(lengths, torch.Tensor) else lengths
        lens = lens.to(mesh.device, torch.int32)
        words, ok = pack_and_validate_u32(x, lens)
        table = counter(words, lens,
                        torch.ones(n, dtype=torch.int32, device=mesh.device))
        return table, _all_gather(mesh, ok)

    return step
