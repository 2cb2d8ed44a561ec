"""Sort-unique-count over packed lane batches, from
shortseq_tpu/count/device.py.

Counting is sort-based grouping, in the JAX package's order:

  1. group equal rows adjacently.  Rows of at most _LEX_SORT_MAX_LANES
     lanes: sort_rows, a stable LSD sort by (length, lane_0, ...,
     lane_{W-1}), lanes compared as unsigned, PAD rows last - one
     torch.sort (CUB radix on the card) per pair of 32-bit key columns,
     least significant pair first, permuting by gathering the index.
     Wider rows: _hash_order, a stable sort by (h1, h2, length) of a
     seeded 64-bit row hash (_row_hash, kernel I in
     shortseq_torch/csrc/count.cu), PAD rows forced to the largest hash.
  2. group_count (kernel D, csrc/count.cu): boundary flags, exact int64
     group sums, one key row per group, n_unique over the live prefix,
     pad normalization and the poison, each sorted row gathered once
     through the sort's permutation, in tiles of GROUP_TILE_ROWS rows.
     On the hash path it also flags a collision: two distinct live rows
     adjacent with one hash.  unique_count then draws the next hash
     family, up to _HASH_MAX_TRIES, and poisons every live count when
     all of them collide.  group_count_plain is D's plain PyTorch
     version, _row_hash_plain I's.

So the tables equal the JAX package's array for array at every width:
ascending key order up to 6 lanes, hash order above.  Only the stale
words of dead (PAD) groups past n_unique may come out in another order
on the hash path, where the JAX package's sort is not stable.

Weights make the op associative - merging count tables is concatenation
+ another unique_count.  Sums are exact in int64; a group whose sum
leaves the int32 range, or every live group when any live input weight is
negative (a poisoned upstream count), reads -1, and every materialization
path raises on it.

Padding convention: callers mark dead rows with length PAD_LENGTH.  Dead
rows sort to the end, may split into several trailing pad groups (stale
words), and are excluded from `n_unique`.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..utils.profiling import scoped

# Sorts after every real length (0..1024).  int32 max keeps it impossible.
PAD_LENGTH = 2**31 - 1

_INT32_MIN = -2**31
_INT32_MAX = 2**31 - 1

#: Widest row (in lanes) that unique_count sorts by key; wider rows are
#: grouped by the row hash.  The JAX package chose 6 for the TPU
#: compiler's limits; the port keeps it because the order of a table is
#: part of its contract with the JAX package, not for speed.
_LEX_SORT_MAX_LANES = 6

#: Hash families tried before the wide path declares the input
#: adversarial and poisons the result (counts = -1, so every
#: materialization raises).  Random data re-draws with probability
#: ~2^-17 per family.
_HASH_MAX_TRIES = 8

_U32 = 0xFFFFFFFF

#: Sorted rows per tile of kernel D (kTileRows in csrc/count.cu): one
#: block gathers, compares and sums a tile, and a group that crosses a
#: tile edge combines its partial sums by atomics.  Edge-case tests build
#: their groups from it.
GROUP_TILE_ROWS = 2048


def empty_table(width: int = 1, device="cuda", rows: int = 1):
    """Canonical empty count table on `device` ("cuda" raises without a
    card): all-pad rows that carry the PAD_LENGTH sentinel (length 0 is a
    live value - an empty read - and sentinel-filtering consumers would
    emit it as a phantom key)."""
    device = _build.resolve_device(device)
    return (torch.zeros((rows, width), dtype=torch.int32, device=device),
            torch.full((rows,), PAD_LENGTH, dtype=torch.int32, device=device),
            torch.zeros(rows, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def sort_rows(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Permutation (int64 [N]) that sorts rows by (length, lane_0, ...,
    lane_{W-1}) with lanes compared as unsigned and ties in input order.

    The key digits are 32-bit: the length, then each lane.  Two digits
    fuse into one int64 key, hi * 2^32 + lo, with hi biased by x ^ -2^31
    (so its signed order is the unsigned order) and lo zero-extended; each
    key is one stable torch.sort, least significant pair first, applied to
    the permutation so far.  Lengths are non-negative (or PAD_LENGTH), so
    their unsigned order is their signed order."""
    n, w = words.shape
    digits = [lengths] + [words[:, j] for j in range(w)]
    perm = None
    end = len(digits)
    while end > 0:
        lo = digits[end - 1]
        if end >= 2:
            hi = digits[end - 2].to(torch.int32) ^ _INT32_MIN
            key = hi.long() * (1 << 32) + (lo.long() & 0xFFFFFFFF)
            end -= 2
        else:
            key = lo.to(torch.int32) ^ _INT32_MIN
            end -= 1
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant c,
    in two 16-bit halves of c so that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _row_hash_plain(words: torch.Tensor, lengths: torch.Tensor,
                    seed: int) -> torch.Tensor:
    """Plain PyTorch version of kernel I: the JAX package's two 32-bit
    row mixes (h1, h2) of seed `seed`, computed in int64 with each value
    kept in [0, 2^32), fused into the int64 sort key
    ((int32)(h1 ^ 2^31)) * 2^32 + h2, whose signed order is the unsigned
    order of (h1, h2).  PAD rows get h1 = h2 = 0xFFFFFFFF."""
    s = (seed * 0x27D4EB2F) & _U32
    length = lengths.long() & _U32
    h1 = _mul32(length ^ s, 0x9E3779B1)
    h2 = _mul32((length + s + 0x165667B1) & _U32, 0x85EBCA77)
    for j in range(words.shape[1]):
        x = words[:, j].long() & _U32
        h1 = _mul32(h1 ^ x, 0xCC9E2D51)
        h1 = h1 ^ (h1 >> 15)
        h2 = _mul32(h2 ^ x, 0x1B873593)
        h2 = h2 ^ (h2 >> 13)
    pad = lengths == PAD_LENGTH
    hi = torch.where(pad, _U32, _fmix32(h1)) ^ 0x80000000
    hi = hi - (hi >> 31 << 32)                   # as a signed int32
    return hi * (1 << 32) + torch.where(pad, _U32, _fmix32(h2))


def _row_hash(words: torch.Tensor, lengths: torch.Tensor,
              seed: int) -> torch.Tensor:
    """Kernel I: each row's int64 sort key of hash family `seed` (see
    _row_hash_plain).  A CUDA tensor launches the kernel; a CPU tensor
    takes the plain version."""
    if words.device.type == "cpu":
        return _row_hash_plain(words, lengths, seed)
    dev = words.device
    _build.check_operand(words, "words", torch.int32, 2, dev)
    _build.check_operand(lengths, "lengths", torch.int32, 1, dev)
    n, w = words.shape
    if lengths.shape[0] != n:
        raise ValueError(f"lengths has {lengths.shape[0]} rows, words has {n}")
    keys = torch.empty(n, dtype=torch.int64, device=dev)
    _build.launch("ssq_row_hash", words.data_ptr(), lengths.data_ptr(),
                  keys.data_ptr(), n, w, seed & _U32)
    _ROW_HASH.launches += 1
    return keys


# The count lives on this function even where a test replaces the name
# _row_hash (the retry's tests do, as the JAX package's do).
_ROW_HASH = _row_hash
_ROW_HASH.launches = 0


def _hash_order(words, lengths, seed: int, by_length=None):
    """(s_hash, perm): the rows in (h1, h2, length) order under hash
    family `seed` - a stable torch.sort of the lengths (`by_length`, when
    the caller has it), then a stable torch.sort of the keys gathered in
    that order - and the keys in that order."""
    if by_length is None:
        by_length = torch.sort(lengths, stable=True).indices
    s_hash, order = torch.sort(_row_hash(words, lengths, seed)[by_length],
                               stable=True)
    return s_hash, by_length[order]


def _adjacent_collision(s_words, s_len, s_hash) -> torch.Tensor:
    """0-d int64: 1 when two adjacent sorted rows are live, have equal
    keys and differ in length or in a lane (JAX _sort_rows_hash's test),
    else 0."""
    differ = (s_len[1:] != s_len[:-1]) \
        | (s_words[1:] != s_words[:-1]).any(dim=1)
    live = (s_len[1:] != PAD_LENGTH) & (s_len[:-1] != PAD_LENGTH)
    return (differ & live & (s_hash[1:] == s_hash[:-1])).any().long()


def _sort_rows_hash(words, lengths, weights):
    """The JAX package's row grouping for wide rows, for the parity
    tests: the rows, lengths and weights in hash order under the first
    hash family without a collision, and whether every family collided.
    Returns (s_lengths, s_words, s_weights, collision 0-d bool).
    unique_count never gathers the sorted rows: D reads them through the
    permutation."""
    by_length = torch.sort(lengths, stable=True).indices
    for seed in range(_HASH_MAX_TRIES):
        s_hash, perm = _hash_order(words, lengths, seed, by_length)
        s_len, s_words = lengths[perm], words[perm]
        collision = _adjacent_collision(s_words, s_len, s_hash)
        if not collision:
            break
    return s_len, s_words, weights[perm], collision.bool()


def group_count_plain(words, lengths, weights, perm, n_out: int,
                      s_hash=None):
    """Plain PyTorch version of kernel D: the group count of the rows in
    `perm` order.  Returns (u_words [n_out, W], u_lengths [n_out],
    counts [n_out], n_unique 0-d), all int32, and with `s_hash` (the
    rows' keys in perm order) also the collision word (0-d int64, 1 when
    two distinct live rows are adjacent with one key)."""
    n, w = words.shape
    dev = words.device
    s_words, s_len, s_wt = words[perm], lengths[perm], weights[perm]
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = (s_len[1:] != s_len[:-1]) \
        | (s_words[1:] != s_words[:-1]).any(dim=1)
    seg = torch.cumsum(is_new, 0) - 1
    starts = is_new.nonzero().flatten()
    live = s_len != PAD_LENGTH
    live_wt = torch.where(live, s_wt, 0).long()
    sums = torch.zeros(len(starts), dtype=torch.int64, device=dev)
    sums.index_add_(0, seg, live_wt)
    wrapped = (sums > _INT32_MAX) | (sums < _INT32_MIN)
    poison = (live_wt < 0).any()
    g_len = s_len[starts]
    g_live = g_len != PAD_LENGTH
    counts = torch.where(g_live & (wrapped | poison), -1, sums)
    counts = torch.where(g_live, counts, 0).to(torch.int32)
    k = min(len(starts), n_out)
    u_words = torch.zeros((n_out, w), dtype=torch.int32, device=dev)
    u_lengths = torch.full((n_out,), PAD_LENGTH, dtype=torch.int32,
                           device=dev)
    u_counts = torch.zeros(n_out, dtype=torch.int32, device=dev)
    u_words[:k] = s_words[starts[:k]]
    u_lengths[:k] = g_len[:k]
    u_counts[:k] = counts[:k]
    table = (u_words, u_lengths, u_counts, g_live.sum().to(torch.int32))
    if s_hash is None:
        return table
    return (*table, _adjacent_collision(s_words, s_len, s_hash))


def group_count(words, lengths, weights, perm, n_out: int, s_hash=None):
    """Kernel D: the group count of the rows in `perm` order (a tile
    launch and a finishing launch, counted as one launch of D), with
    `s_hash` also the collision word, as group_count_plain.  A CUDA
    tensor launches the kernel; a CPU tensor takes the plain version."""
    if words.device.type == "cpu":
        return group_count_plain(words, lengths, weights, perm, n_out,
                                 s_hash)
    dev = words.device
    _build.check_operand(words, "words", torch.int32, 2, dev)
    n, w = words.shape
    operands = [("lengths", lengths, torch.int32),
                ("weights", weights, torch.int32),
                ("perm", perm, torch.int64)]
    if s_hash is not None:
        operands.append(("s_hash", s_hash, torch.int64))
    for name, t, dtype in operands:
        _build.check_operand(t, name, dtype, 1, dev)
        if t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} rows, words has {n}")
    if n > _INT32_MAX:
        raise ValueError(f"{n} rows: kernel D counts at most 2^31 - 1")
    tile_rows = _build.cuda_lib().ssq_group_tile_rows()
    if tile_rows != GROUP_TILE_ROWS:
        raise RuntimeError(f"kernel D was built with {tile_rows}-row tiles, "
                           f"GROUP_TILE_ROWS is {GROUP_TILE_ROWS}")
    tiles = -(-n // GROUP_TILE_ROWS)
    # Zeroed: the tile counter, the poison word, the group total, the
    # collision word, one look-back state per tile, then one int64 sum
    # per kept group.
    scratch = torch.zeros(4 + tiles + min(n, n_out), dtype=torch.int64,
                          device=dev)
    sums = scratch[4 + tiles:]
    u_words = torch.empty((n_out, w), dtype=torch.int32, device=dev)
    u_lengths = torch.empty(n_out, dtype=torch.int32, device=dev)
    counts = torch.empty(n_out, dtype=torch.int32, device=dev)
    n_unique = torch.zeros((), dtype=torch.int32, device=dev)
    _build.launch("ssq_group_tile", words.data_ptr(), lengths.data_ptr(),
                  weights.data_ptr(), perm.data_ptr(),
                  None if s_hash is None else s_hash.data_ptr(),
                  scratch.data_ptr(), sums.data_ptr(), u_words.data_ptr(),
                  u_lengths.data_ptr(), n_unique.data_ptr(), n, w, n_out)
    _build.launch("ssq_group_finish", u_words.data_ptr(),
                  u_lengths.data_ptr(), counts.data_ptr(), sums.data_ptr(),
                  scratch.data_ptr(), n_out, w)
    group_count.launches += 1
    if s_hash is None:
        return u_words, u_lengths, counts, n_unique
    return u_words, u_lengths, counts, n_unique, scratch[3]


group_count.launches = 0


@scoped("ssq.unique_count")
def unique_count(words: torch.Tensor, lengths: torch.Tensor,
                 weights: torch.Tensor, n_out: int | None = None):
    """Group identical (length, words-row) keys and sum their weights.

    Args:
      words:   `[N, W]` int32 packed lanes (uint32 bits, zero-padded past
               each length).
      lengths: `[N]` int32; PAD_LENGTH marks dead rows (weight ignored).
      weights: `[N]` int32 per-row counts (1 for raw reads; table counts
               when merging).
    Returns:
      (u_words `[M, W]`, u_lengths `[M]`, u_counts `[M]`, n_unique 0-d),
      all int32 on the inputs' device, with M = n_out or N; groups in
      ascending key order for W <= _LEX_SORT_MAX_LANES, in hash order
      above, as in the JAX package; rows at and past n_unique are padding
      (length PAD_LENGTH, count 0).  An n_out below the unique count
      keeps the first n_out groups and fetch_table raises on the table.

    At W > _LEX_SORT_MAX_LANES each hash family's collision word is read
    on the host (one small copy from the card a call) to decide whether
    to draw the next one.
    """
    if words.dim() != 2:
        raise ValueError(f"words must be [N, W], got {tuple(words.shape)}")
    n, w = words.shape
    if lengths.shape != (n,) or weights.shape != (n,):
        raise ValueError(
            f"lengths {tuple(lengths.shape)} and weights "
            f"{tuple(weights.shape)} must both be [{n}]")
    if n_out is None:
        n_out = n
    if n == 0:
        # An empty batch (e.g. an empty file) keeps every shape rule: a
        # table of max(n_out, 1) pad rows.
        return empty_table(w, words.device, max(n_out, 1))
    if w <= _LEX_SORT_MAX_LANES:
        perm = sort_rows(words, lengths)
        return group_count(words, lengths, weights, perm, n_out)
    by_length = torch.sort(lengths, stable=True).indices
    for seed in range(_HASH_MAX_TRIES):
        s_hash, perm = _hash_order(words, lengths, seed, by_length)
        *table, collision = group_count(words, lengths, weights, perm, n_out,
                                        s_hash)
        if not collision:
            return tuple(table)
    # Every family collided: only an input crafted against these constants
    # gets here.  The last family's table, every live count poisoned, so
    # that every materialization raises instead of reading a mis-grouped
    # table.
    u_words, u_lengths, counts, n_unique = table
    live = torch.arange(n_out, device=counts.device) < n_unique
    return u_words, u_lengths, torch.where(live, -1, counts), n_unique


def count_batch(words: torch.Tensor, lengths: torch.Tensor):
    """Count a raw read batch: every row weight 1."""
    return unique_count(words, lengths,
                        torch.ones(words.shape[0], dtype=torch.int32,
                                   device=words.device))


def fetch_table(u_words, u_lengths, u_counts, n_unique):
    """Fetch only the live prefix of a count table to host.

    Returns host numpy arrays (words [n, W] uint32, lengths [n] int32,
    counts [n] int32, n).  A table with fewer rows than n_unique (n_out
    too small) raises instead of dropping keys."""
    n = int(n_unique)
    total = u_words.shape[0]
    if n > total:
        raise ValueError(
            f"count table overflow: {n} unique keys but only {total} "
            f"output rows (n_out too small)")
    return (u_words[:n].cpu().numpy().view(np.uint32),
            u_lengths[:n].cpu().numpy(), u_counts[:n].cpu().numpy(), n)


def table_to_host(table):
    """A (words, lengths, counts, n_unique) count table -> compact host
    (words, lengths, counts), raising on n_out overflow and on poisoned
    (count < 0) entries: a poisoned count re-merged with more weight
    could land positive and pass every later check."""
    w, lens, cnts, _ = fetch_table(*table)
    if len(cnts) and int(cnts.min()) < 0:
        raise OverflowError(
            "count table entry exceeded int32; merge in smaller pieces")
    return w, lens, cnts


def counts_to_host_scattered(u_words, u_lengths, u_counts):
    """Like counts_to_host for tables whose live rows are NOT contiguous:
    filters by the PAD_LENGTH sentinel instead of slicing a prefix."""
    lens = u_lengths.cpu().numpy()
    live = np.flatnonzero(lens != PAD_LENGTH)
    return _rows_to_table(u_words.cpu().numpy().view(np.uint32)[live],
                          lens[live], u_counts.cpu().numpy()[live])


def counts_to_host(u_words, u_lengths, u_counts, n_unique):
    """Count table -> list of ((length, blocks tuple), count) on host.

    Blocks are reference uint64 values (lane pair 2b, 2b+1 fused), ready
    for the Counter materialization in api.counter.  Only the live prefix
    is transferred (fetch_table); an n_out below the unique count raises.
    """
    w, lens, cnts, _n = fetch_table(u_words, u_lengths, u_counts, n_unique)
    return _rows_to_table(w, lens, cnts)


def _rows_to_table(w, lens, cnts):
    # Counts are int32; a table row that overflowed it reads -1 (poison) -
    # detect instead of silently corrupting (the reference's Python ints
    # are unbounded).
    cnts = np.asarray(cnts)
    if len(cnts) and int(cnts.min()) < 0:
        raise OverflowError(
            "count table entry exceeded int32; merge in smaller pieces")
    w = np.asarray(w).astype(np.uint64)
    if w.shape[1] % 2:  # odd lane count: pad to a full 64-bit block
        w = np.pad(w, ((0, 0), (0, 1)))
    blocks64 = w[:, 0::2] | (w[:, 1::2] << np.uint64(32))
    out = []
    for i in range(len(lens)):
        length = int(lens[i])
        nblocks = max(1, -(-length // 32))
        out.append(((length, tuple(int(b) for b in blocks64[i, :nblocks])),
                    int(cnts[i])))
    return out
