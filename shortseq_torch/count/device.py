"""Sort-unique-count over packed lane batches, from
shortseq_tpu/count/device.py.

Counting is sort-based grouping, in the JAX package's order:

  1. group equal rows adjacently, by kernel S (csrc/sort.cu), a stable
     LSD radix sort over 8-bit digits that skips every digit holding one
     value over all rows (the plan, made on the card: _sort_table_plain
     is its plain version, _sort_plan the digits it keeps), with no read
     back to the host.  Rows of at most
     _LEX_SORT_MAX_LANES lanes: sort_rows, by (length, lane_0, ...,
     lane_{W-1}), lanes compared as unsigned, PAD rows last.  Wider rows:
     _sort_keys for each hash family, a stable sort by (h1, h2, length)
     of a seeded 64-bit row hash (_row_hash, kernel I in
     shortseq_torch/csrc/count.cu), PAD rows forced to the largest hash;
     the first family sorts the lengths too, and the rest start from
     that length order.  sort_rows_plain and _sort_keys_plain are S's
     plain versions: the same plan, one stable torch.sort a digit.
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

import collections

import numpy as np
import torch

from .. import _build
from ..utils.profiling import named_scope, scoped

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


#: Rows per tile of kernel S's digit passes (kTileRows in csrc/sort.cu):
#: edge-case tests build their sizes from it.
SORT_TILE_ROWS = 4096

#: Kernel S's key columns besides a lane j (>= 0) and a pair _PAIR + j
#: (lanes j and j + 1 as one unsigned 64-bit key, lane j the high half):
#: the length as int32 (bit 31 flipped, so its signed order is the
#: unsigned one), the length mapped to 11 bits (PAD_LENGTH as 2047, when
#: every live length is at most 2046), and kernel I's int64 hash key (bit
#: 63 flipped, so its unsigned order is that of (h1, h2)).
_PAIR = 1 << 16
_LEN_FULL, _LEN_MAPPED, _HASH_KEY = -1, -2, -3
_COLUMN_BYTES = {_LEN_FULL: 4, _LEN_MAPPED: 2, _HASH_KEY: 8}
_SLOT_AFTER_LANES = {_LEN_FULL: 0, _LEN_MAPPED: 4, _HASH_KEY: 6}
_MAPPED_PAD = 2047
_INT64_MIN = -2**63
#: The widest rows sort_rows takes on the card (kMaxLanes in
#: csrc/sort.cu): reads of up to 1024 nt.
_SORT_MAX_LANES = 64

#: What one call of S sorts (ssq_sort's `part` in csrc/sort.cu): the key
#: path's rows, the hash path's first family (the lengths, then the keys
#: from their order) or a later family (the keys from a given order).
_KEY_PATH, _HASH_FIRST, _HASH_NEXT = 0, 1, 2

#: An entry of S's pass table (int32 [4]: mode, k, gather, out): a
#: candidate digit that is constant (skipped), that takes pass k of its
#: sort, or, when no digit of the sort varies, its last candidate, which
#: copies the input order to the result; out: carried keys and indices,
#: indices only, or the sort's result.
_SKIP, _PASS, _COPY = 0, 1, 2
_CARRY, _INDICES, _RESULT = 0, 1, 2


def _digit_slot(col: int, shift: int, w: int) -> int:
    """Row of a digit in S's histograms (digit_slot in csrc/sort.cu): 4 a
    lane, then the length's 4, its 2 under the map, the hash key's 8; a
    pair's low 4 digits are lane j + 1's, its high 4 lane j's."""
    byte = shift // 8
    if col >= _PAIR:
        return 4 * (col - _PAIR) + (4 + byte if byte < 4 else byte - 4)
    if col >= 0:
        return 4 * col + byte
    return 4 * w + _SLOT_AFTER_LANES[col] + byte


def _hist_size(w: int) -> int:
    """int32 words of S's histograms of W lanes: 256 bins a digit, then
    the flag (a live length above 2046)."""
    return (4 * w + 14) * 256 + 1


def _sort_plan(hist: np.ndarray, w: int, columns) -> np.ndarray:
    """S's digits, least significant first, as int32 [passes, 2] (column,
    shift): each digit of `columns` (least significant column first; the
    length as _LEN_MAPPED unless the flag says a live length exceeds
    2046, then _LEN_FULL) whose histogram has more than one non-empty
    bin.  A stable sort by a digit that holds one value is the identity,
    so leaving it out changes nothing."""
    varies = np.count_nonzero(hist[:-1].reshape(-1, 256), axis=1) > 1
    plan = []
    for col in columns:
        if col == _LEN_MAPPED and hist[-1]:
            col = _LEN_FULL
        nbytes = 8 if col >= _PAIR else _COLUMN_BYTES.get(col, 4)
        plan += [(col, 8 * byte) for byte in range(nbytes)
                 if varies[_digit_slot(col, 8 * byte, w)]]
    return np.array(plan, np.int32).reshape(-1, 2)


def _candidates(columns) -> list:
    """S's candidate digits of a sort by `columns` (least significant
    first), as (column, shift) in pass order (cand_at in csrc/sort.cu): a
    pair's 8 digits, a lane's 4, the hash key's 8, and for the length
    (_LEN_MAPPED) the mapped length's 2 then the int32 length's 4, of
    which the histograms' flag lets only one set vary."""
    out = []
    for col in columns:
        if col == _LEN_MAPPED:
            out += [(_LEN_MAPPED, 0), (_LEN_MAPPED, 8)] \
                + [(_LEN_FULL, 8 * b) for b in range(4)]
        else:
            nbytes = 8 if col >= _PAIR else _COLUMN_BYTES.get(col, 4)
            out += [(col, 8 * b) for b in range(nbytes)]
    return out


def _sort_columns(w: int, part: int) -> list:
    """The sorts of one S call, each its columns: the key path's, or on
    the hash path the length then the key (the first family), or the key
    alone."""
    if part == _KEY_PATH:
        return [_key_path_columns(w)]
    return ([[_LEN_MAPPED]] if part == _HASH_FIRST else []) + [[_HASH_KEY]]


def _sort_table_plain(hist: torch.Tensor, w: int, part: int) -> torch.Tensor:
    """Plain PyTorch version of S's plan launch (sort_plan_kernel): the
    pass table of one call, int32 [candidates, 4] (mode, k, gather, out;
    see _SKIP), from its histograms (int32 [_hist_size(W)], W = 0 on the
    hash path).  A candidate varies when its digit has more than one
    non-empty bin; the mapped length's digits only without the flag, the
    int32 length's only with it.  Pass k of a sort reads half (k - 1) % 2
    of the ping-pong buffers (k = 0: the sort's input order) and writes
    half k % 2; it gathers when it is its column's first varying digit;
    its output is the sort's result when it is the last varying digit,
    indices only when the next is another column's, else carried keys and
    indices."""
    hist = hist.long()
    big = bool(hist[-1])
    nonzero = (hist[:-1].view(-1, 256) != 0).sum(1)
    table = []
    for columns in _sort_columns(w, part):
        cands = _candidates(columns)
        rows = [[_SKIP, 0, 0, 0] for _ in cands]
        active = [i for i, (col, shift) in enumerate(cands)
                  if nonzero[_digit_slot(col, shift, w)] > 1
                  and not (col == _LEN_MAPPED and big)
                  and not (col == _LEN_FULL and not big)]
        for k, i in enumerate(active):
            col = cands[i][0]
            gather = k == 0 or cands[active[k - 1]][0] != col
            if k == len(active) - 1:
                out = _RESULT
            else:
                out = _INDICES if cands[active[k + 1]][0] != col else _CARRY
            rows[i] = [_PASS, k, int(gather), out]
        if not active:
            rows[-1][0] = _COPY
        table += rows
    return torch.tensor(table, dtype=torch.int32).view(-1, 4)


def _key_column(col: int, words, lengths, keys) -> torch.Tensor:
    """A column of S's keys as int64 holding the unsigned key (a pair and
    the hash key as int64 bits: their bytes are the unsigned key's)."""
    if col >= _PAIR:
        j = col - _PAIR
        return (words[:, j].long() << 32) | (words[:, j + 1].long() & _U32)
    if col >= 0:
        return words[:, col].long() & _U32
    if col == _LEN_FULL:
        return (lengths.long() & _U32) ^ 0x80000000
    if col == _LEN_MAPPED:
        return torch.where(lengths == PAD_LENGTH, _MAPPED_PAD,
                           lengths.long() & _U32)
    return keys ^ _INT64_MIN


def _sort_hist_plain(words, lengths, keys) -> torch.Tensor:
    """Plain PyTorch version of S's histograms: int32 [_hist_size(W)],
    each digit's 256 bins (of the columns given; words None: W = 0), then
    the flag, 1 when a live length exceeds 2046.  The length's digits are
    those of the mapped length and of the int32 length both."""
    w = 0 if words is None else words.shape[1]
    ref = next(t for t in (words, lengths, keys) if t is not None)
    hist = torch.zeros(_hist_size(w), dtype=torch.int64, device=ref.device)
    cols = list(range(w))
    if lengths is not None:
        big = ((lengths != PAD_LENGTH)
               & ((lengths.long() & _U32) > 2046)).any()
        hist[-1] = big.long()
        cols += [_LEN_MAPPED, _LEN_FULL]
    if keys is not None:
        cols.append(_HASH_KEY)
    for col in cols:
        key = _key_column(col, words, lengths, keys)
        for byte in range(_COLUMN_BYTES.get(col, 4)):
            slot = _digit_slot(col, 8 * byte, w)
            hist[slot * 256:(slot + 1) * 256] = torch.bincount(
                (key >> 8 * byte) & 255, minlength=256)
    return hist.to(torch.int32)


def _digit_sort_plain(plan, words, lengths, keys, order=None):
    """S's digit passes as tensors: for each (column, shift) of `plan`, a
    stable torch.sort of that digit of the rows in the order so far.
    Returns the int64 order (from `order`, else the input order)."""
    n = (lengths if lengths is not None else keys).shape[0]
    dev = (lengths if lengths is not None else keys).device
    order = torch.arange(n, device=dev) if order is None else order.long()
    for col, shift in plan.tolist():
        key = _key_column(col, words, lengths, keys)[order]
        order = order[torch.sort((key >> shift) & 255, stable=True).indices]
    return order


def _key_path_columns(w: int) -> list:
    """sort_rows' columns, least significant first: the lane pairs
    (W-2, W-1), (W-4, W-3), ..., then lane 0 alone when W is odd, then the
    length."""
    return [_PAIR + j for j in range(w - 2, -1, -2)] \
        + ([0] if w % 2 else []) + [_LEN_MAPPED]


def sort_rows_plain(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of sort_rows: S's plan (the same columns, the
    same length map, the same skipped digits), one stable torch.sort a
    digit."""
    w = words.shape[1]
    hist = _sort_hist_plain(words, lengths, None).cpu().numpy()
    plan = _sort_plan(hist, w, _key_path_columns(w))
    return _digit_sort_plain(plan, words, lengths, None)


def _check_sort_operands(words, lengths, keys=None):
    ref = next(t for t in (words, lengths, keys) if t is not None)
    dev, n = ref.device, ref.shape[0]
    if words is not None:
        _build.check_operand(words, "words", torch.int32, 2, dev)
        if words.shape[1] > _SORT_MAX_LANES:
            raise ValueError(f"kernel S sorts rows of at most "
                             f"{_SORT_MAX_LANES} lanes, not {words.shape[1]}")
    for name, t, dtype in (("lengths", lengths, torch.int32),
                           ("keys", keys, torch.int64)):
        if t is not None:
            _build.check_operand(t, name, dtype, 1, dev)
            if t.shape[0] != n:
                raise ValueError(f"{name} has {t.shape[0]} rows, not {n}")
    if n > _INT32_MAX:
        raise ValueError(f"{n} rows: kernel S sorts at most 2^31 - 1")
    return dev, n


#: One S call's outputs on the card (perm, s_hash, order) and views of its
#: scratch: the histograms (int32 [_hist_size(W)]) and the pass table
#: (int32 [candidates, 4]) that the plan launch made.
_SortRun = collections.namedtuple("_SortRun", "perm s_hash order hist table")


def _sort_launch(words, lengths, keys, idx_in, part: int, n: int):
    """Kernel S: one ssq_sort call (csrc/sort.cu) of `part` (_KEY_PATH:
    words and lengths; _HASH_FIRST: lengths, then keys from their order;
    _HASH_NEXT: keys from `idx_in`, int32 [N] or None for the input
    order).  The memset, the histograms, the plan and one pass launch a
    candidate digit are queued on the current stream; nothing is read
    back.  Returns a _SortRun: perm (int64 [N]), s_hash (int64 [N] when
    keys are sorted), order (the _HASH_FIRST call's int32 length
    order)."""
    dev = (keys if keys is not None else lengths).device
    w = words.shape[1] if part == _KEY_PATH else 0
    cands = sum(len(_candidates(c)) for c in _sort_columns(w, part))
    tile_rows = _build.cuda_lib().ssq_sort_tile_rows()
    if tile_rows != SORT_TILE_ROWS:
        raise RuntimeError(f"kernel S was built with {tile_rows}-row tiles, "
                           f"SORT_TILE_ROWS is {SORT_TILE_ROWS}")
    tiles = -(-n // tile_rows)
    counter_words = cands + cands % 2
    hist_words = (_hist_size(w) + 1) // 2
    # Zeroed by the entry point: a tile counter a candidate, the pass
    # table, the histograms, one look-back state per (tile, bin) shared by
    # every pass (each tags its states with its candidate's slot).
    scratch = torch.empty(counter_words + 2 * cands + hist_words
                          + tiles * 256, dtype=torch.int64, device=dev)
    wide = part != _KEY_PATH or w >= 2
    key_buf = torch.empty(2 * n * (2 if wide else 1), dtype=torch.int32,
                          device=dev)
    idx_buf = torch.empty(2 * n, dtype=torch.int32, device=dev)
    perm = torch.empty(n, dtype=torch.int64, device=dev)
    s_hash = torch.empty(n, dtype=torch.int64, device=dev) \
        if keys is not None else None
    by_length = torch.empty(n, dtype=torch.int32, device=dev) \
        if part == _HASH_FIRST else None
    _build.launch("ssq_sort", None if words is None else words.data_ptr(),
                  w, None if lengths is None else lengths.data_ptr(),
                  None if keys is None else keys.data_ptr(),
                  None if idx_in is None else idx_in.data_ptr(), part,
                  scratch.data_ptr(), key_buf.data_ptr(), idx_buf.data_ptr(),
                  perm.data_ptr(),
                  None if s_hash is None else s_hash.data_ptr(),
                  None if by_length is None else by_length.data_ptr(), n)
    table = scratch[counter_words:counter_words + 2 * cands] \
        .view(torch.int32).view(cands, 4)
    hist = scratch[counter_words + 2 * cands:][:hist_words] \
        .view(torch.int32)[:_hist_size(w)]
    return _SortRun(perm, s_hash, by_length, hist, table)


def sort_rows(words: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Permutation (int64 [N]) that sorts rows by (length, lane_0, ...,
    lane_{W-1}) with lanes compared as unsigned, lengths as int32, and
    ties in input order.

    Kernel S: a histogram launch, the plan on the card (digits that hold
    one value skipped), then one launch a candidate digit, the last lane
    pair first, the length last; no host read.  A CUDA tensor launches the
    kernel; a CPU tensor takes the plain version."""
    if words.device.type == "cpu":
        return sort_rows_plain(words, lengths)
    dev, n = _check_sort_operands(words, lengths)
    if n == 0:
        return torch.empty(0, dtype=torch.int64, device=dev)
    sort_rows.launches += 1
    return _sort_launch(words, lengths, None, None, _KEY_PATH, n).perm


# Every call that launches S counts here: sort_rows and _sort_keys.
sort_rows.launches = 0


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


def _length_order_plain(lengths: torch.Tensor):
    """The rows' stable order by length (int64), the hash path's first
    key, or None when every row has one length (the input order already
    is the length order): the plain version of the length passes of
    _sort_keys."""
    hist = _sort_hist_plain(None, lengths, None).cpu().numpy()
    plan = _sort_plan(hist, 0, [_LEN_MAPPED])
    if len(plan) == 0:
        return None
    return _digit_sort_plain(plan, None, lengths, None)


def _sort_keys_plain(keys: torch.Tensor, lengths=None, by_length=None):
    """Plain PyTorch version of _sort_keys."""
    if lengths is not None:
        by_length = _length_order_plain(lengths)
    hist = _sort_hist_plain(None, None, keys).cpu().numpy()
    plan = _sort_plan(hist, 0, [_HASH_KEY])
    perm = _digit_sort_plain(plan, None, None, keys, by_length)
    return keys[perm], perm, by_length


def _sort_keys(keys: torch.Tensor, lengths=None, by_length=None):
    """(s_hash, perm, by_length): a stable sort of kernel I's int64 keys
    (signed order, which is the unsigned order of (h1, h2)), the keys in
    that order, and the length order it started from.  With `lengths`
    the rows are sorted by (key, length): the length order comes from the
    same call, and is returned (int32 on the card, where every row having
    one length gives the identity; None from the plain version then) for
    the next hash family, which passes it as `by_length` (None: the input
    order) and sorts only its keys.  Kernel S on a CUDA tensor, with no
    host read; the plain version on a CPU tensor."""
    if keys.device.type == "cpu":
        return _sort_keys_plain(keys, lengths, by_length)
    _, n = _check_sort_operands(None, lengths, keys)
    if by_length is not None:
        _build.check_operand(by_length, "by_length", torch.int32, 1,
                             keys.device)
    if n == 0:
        perm = torch.empty(0, dtype=torch.int64, device=keys.device)
        order = torch.empty(0, dtype=torch.int32, device=keys.device)
        return keys[:0], perm, order if lengths is not None else by_length
    sort_rows.launches += 1
    if lengths is not None:
        run = _sort_launch(None, lengths, keys, None, _HASH_FIRST, n)
        return run.s_hash, run.perm, run.order
    run = _sort_launch(None, None, keys, by_length, _HASH_NEXT, n)
    return run.s_hash, run.perm, by_length


def _hash_order_plain(words, lengths, seed: int, by_length=None):
    """Plain PyTorch version of _hash_order."""
    return _sort_keys_plain(_row_hash(words, lengths, seed),
                            lengths if by_length is None else None,
                            by_length)[:2]


def _hash_order(words, lengths, seed: int, by_length=None):
    """(s_hash, perm): the rows in (h1, h2, length) order under hash
    family `seed`, and their keys in that order: kernel I's keys through
    _sort_keys, from the length order `by_length` (an earlier family's),
    or sorted with the keys when None."""
    return _sort_keys(_row_hash(words, lengths, seed),
                      lengths if by_length is None else None, by_length)[:2]


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
    by_length = None
    for seed in range(_HASH_MAX_TRIES):
        s_hash, perm, by_length = _sort_keys(
            _row_hash(words, lengths, seed), None if seed else lengths,
            by_length)
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
    to draw the next one; at most _LEX_SORT_MAX_LANES lanes nothing is
    read back.
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
    return _hash_count(words, lengths, weights, n_out)


@scoped("ssq.hash_count")
def _hash_count(words, lengths, weights, n_out: int):
    """unique_count's route for rows over _LEX_SORT_MAX_LANES lanes: for
    each hash family, kernel I, S over its keys, D with the collision
    word, and the host's read of that word."""
    # The first family sorts the lengths with its keys; the rest start
    # from that length order and sort only their keys.
    by_length = None
    for seed in range(_HASH_MAX_TRIES):
        s_hash, perm, by_length = _sort_keys(
            _row_hash(words, lengths, seed), None if seed else lengths,
            by_length)
        *table, collision = group_count(words, lengths, weights, perm, n_out,
                                        s_hash)
        if not int(d2h(collision)):
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


def h2d(t: torch.Tensor, device, pinned: bool = False) -> torch.Tensor:
    """Host tensor `t` on `device`, in the ssq.h2d range: with `pinned`,
    through pinned memory by a non-blocking copy on CUDA (PyTorch's host
    allocator holds the pinned buffer until the copy has run), else a
    plain (pageable, blocking) copy.  A copy to a CUDA device adds its
    bytes to `h2d.bytes` and one to `h2d.copies`; on a CPU device nothing
    crosses and neither moves."""
    device = torch.device(device)
    with named_scope("ssq.h2d"):
        if device.type != "cuda":
            return t.to(device)
        out = (t.pin_memory() if pinned else t).to(device,
                                                   non_blocking=pinned)
    h2d.bytes += t.numel() * t.element_size()
    h2d.copies += 1
    return out


def d2h(t):
    """Card tensor `t` on the host (`t.cpu()`), in the ssq.d2h range: a
    blocking read, so the range holds the host's wait for the card's
    queue as well as the copy.  A copy from a CUDA device adds its bytes
    to `d2h.bytes` and one to `d2h.copies` (so `.copies` counts the
    host's syncs); a CPU tensor is returned as it is and moves neither.
    Anything but a tensor (a count already read) is returned as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    with named_scope("ssq.d2h"):
        out = t.cpu()
    if t.is_cuda:
        d2h.bytes += t.numel() * t.element_size()
        d2h.copies += 1
    return out


# The count path's copies between the host and a CUDA device, counted as
# the kernels' wrappers count their launches.
h2d.bytes = h2d.copies = d2h.bytes = d2h.copies = 0


def fetch_table(u_words, u_lengths, u_counts, n_unique):
    """Fetch only the live prefix of a count table to host.

    Returns host numpy arrays (words [n, W] uint32, lengths [n] int32,
    counts [n] int32, n).  A table with fewer rows than n_unique (n_out
    too small) raises instead of dropping keys."""
    n = int(d2h(n_unique))
    total = u_words.shape[0]
    if n > total:
        raise ValueError(
            f"count table overflow: {n} unique keys but only {total} "
            f"output rows (n_out too small)")
    return (d2h(u_words[:n]).numpy().view(np.uint32),
            d2h(u_lengths[:n]).numpy(), d2h(u_counts[:n]).numpy(), n)


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
    lens = d2h(u_lengths).numpy()
    live = np.flatnonzero(lens != PAD_LENGTH)
    return _rows_to_table(d2h(u_words).numpy().view(np.uint32)[live],
                          lens[live], d2h(u_counts).numpy()[live])


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
