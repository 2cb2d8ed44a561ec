"""Kernel S's plan and plain versions (shortseq_torch.count.device:
sort_rows_plain, _length_order_plain, _sort_keys_plain, _hash_order_plain)
against numpy's stable lexsort and against the JAX package's row sorts
(shortseq_tpu.count.device _sort_rows_lex and _sort_rows_hash, run on the
CPU), on inputs made by numpy from a seed.  Every comparison is exact.

The plan is S's list of 8-bit digits, least significant first, with every
digit that holds one value over all rows left out; the length enters
mapped to 11 bits (PAD_LENGTH as 2047) unless a live length exceeds 2046.
On the card one launch turns the histograms into a pass table over every
candidate digit (_sort_table_plain is its plain version); the table is
held here to the plan and to the host loop that queued the passes before
the plan moved to the card.  The card's test holds the kernel to these
plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shortseq_tpu.count.device as jdev
import shortseq_torch.count.device as tdev
from chip_smoke import sort_edge_cases, sort_rows_library
from shortseq_torch.ops.lanes import from_numpy_u32

PAD = tdev.PAD_LENGTH
MAPPED, FULL, KEY, PAIR = (tdev._LEN_MAPPED, tdev._LEN_FULL, tdev._HASH_KEY,
                           tdev._PAIR)
EDGE_CASES = {name: (words, lengths) for name, words, lengths
              in sort_edge_cases(tdev.SORT_TILE_ROWS)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _rows(rng, n, w, lens, pad_share=0.0):
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64) \
        .astype(np.uint32)
    lengths = rng.choice(np.asarray(lens, np.int32), size=n)
    lengths[rng.random(n) < pad_share] = PAD
    return words, lengths


def _plan(words, lengths):
    w = words.shape[1]
    hist = tdev._sort_hist_plain(from_numpy_u32(words),
                                 torch.from_numpy(lengths), None)
    return tdev._sort_plan(hist.numpy(), w, tdev._key_path_columns(w))


def _length_plan(lengths):
    hist = tdev._sort_hist_plain(None, torch.from_numpy(lengths), None)
    return tdev._sort_plan(hist.numpy(), 0, [MAPPED]).tolist()


def _lexsort(words, lengths):
    """numpy's stable order by (length, lane_0, ..., lane_{W-1})."""
    w = words.shape[1]
    return np.lexsort([words[:, k] for k in range(w - 1, -1, -1)]
                      + [lengths])


def _jax_keys(words, lengths, seed):
    """Kernel I's int64 keys from JAX's _row_hash with _sort_rows_hash's
    PAD forcing: ((int32)(h1 ^ 2^31)) << 32 | h2."""
    h1, h2 = (np.asarray(h, np.uint64) for h in jdev._row_hash(
        jnp.asarray(words), jnp.asarray(lengths), jnp.int32(seed)))
    pad = lengths == PAD
    h1 = np.where(pad, np.uint64(0xFFFFFFFF), h1)
    h2 = np.where(pad, np.uint64(0xFFFFFFFF), h2)
    return ((h1 ^ np.uint64(0x80000000)) << np.uint64(32) | h2) \
        .view(np.int64), h1, h2


# -- the plan ---------------------------------------------------------------


@pytest.mark.parametrize("pad_share,want", [
    (0.0, [(MAPPED, 0)]),
    (0.1, [(MAPPED, 0), (MAPPED, 8)]),
], ids=["no PAD", "PAD"])
def test_plan_lengths_below_256(pad_share, want):
    rng = np.random.default_rng(1)
    _, lengths = _rows(rng, 500, 1, range(15, 33), pad_share)
    assert _length_plan(lengths) == [list(x) for x in want]


def test_plan_lengths_up_to_1024_with_pad_stay_mapped():
    lengths = np.array([0, 1024, PAD, 300, 1024], np.int32)
    assert _length_plan(lengths) == [[MAPPED, 0], [MAPPED, 8]]


@pytest.mark.parametrize("pad_share,digits", [(0.0, 2), (0.1, 4)],
                         ids=["no PAD", "PAD"])
def test_plan_live_length_above_2046_takes_the_full_length(pad_share,
                                                           digits):
    rng = np.random.default_rng(2)
    _, lengths = _rows(rng, 400, 1, [3, 150, 2047, 5000], pad_share)
    plan = _length_plan(lengths)
    assert [c for c, _ in plan] == [FULL] * digits


def test_plan_every_key_equal_is_empty_and_the_identity():
    words = np.tile(np.array([[7, 0x80000001]], np.uint32), (300, 1))
    lengths = np.full(300, 31, np.int32)
    assert _plan(words, lengths).shape == (0, 2)
    perm = tdev.sort_rows_plain(from_numpy_u32(words),
                                torch.from_numpy(lengths))
    np.testing.assert_array_equal(perm.numpy(), np.arange(300))


def test_plan_skips_constant_lane_digits():
    # Reads of at most 16 nt leave lane 1 zero: the pair (lane 0, lane 1)
    # keeps only lane 0's digits (its high half, shifts 32-56), then the
    # length's low digit.
    rng = np.random.default_rng(3)
    words, lengths = _rows(rng, 600, 2, range(10, 17))
    words[:, 1] = 0
    assert _plan(words, lengths).tolist() == \
        [[PAIR, 32], [PAIR, 40], [PAIR, 48], [PAIR, 56], [MAPPED, 0]]


@pytest.mark.parametrize("w,columns", [
    (1, [0, MAPPED]), (2, [PAIR, MAPPED]), (5, [PAIR + 3, PAIR + 1, 0, MAPPED]),
    (6, [PAIR + 4, PAIR + 2, PAIR, MAPPED])])
def test_key_path_columns(w, columns):
    assert tdev._key_path_columns(w) == columns


def test_plan_of_hash_keys_runs_all_8_digits():
    rng = np.random.default_rng(4)
    words, lengths = _rows(rng, 800, 10, [150])
    keys = tdev._row_hash_plain(from_numpy_u32(words),
                                torch.from_numpy(lengths), 0)
    hist = tdev._sort_hist_plain(None, None, keys)
    plan = tdev._sort_plan(hist.numpy(), 0, [KEY])
    assert plan.tolist() == [[KEY, 8 * k] for k in range(8)]


# -- the pass table (the plan launch's plain version) -------------------------


def _host_loop(plan, result):
    """The host loop that queued S's passes before the plan moved to the
    card (ssq_sort_passes of csrc/sort.cu before it): for pass p of
    `plan`, (the half it read, None for the input order; the half it
    wrote; whether it gathered; its output: 0 carry, 1 indices, 2 the
    permutation, 3 the permutation and s_hash), and the half the last
    pass's indices went to when the sort's result was not the
    permutation."""
    plan = plan.tolist()
    steps = []
    for p, (col, _) in enumerate(plan):
        first = p == 0 or plan[p - 1][0] != col
        last_of_col = p == len(plan) - 1 or plan[p + 1][0] != col
        out = 1 if last_of_col else 0
        if p == len(plan) - 1 and result:
            out = 3 if col == KEY else 2
        steps.append((None if p == 0 else (p + 1) % 2, p % 2, first, out))
    return steps, (len(plan) - 1) % 2


def _hist_case(name):
    """(histograms int32, W, the call's part) of one case the plan tests
    above build."""
    rng = np.random.default_rng(8)
    if name.startswith("lengths"):
        lens, pad_share = {
            "lengths below 256": (range(15, 33), 0.0),
            "lengths below 256, PAD": (range(15, 33), 0.1),
            "lengths up to 1024, PAD": ([0, 1024, 300], 0.2),
            "lengths above 2046": ([3, 150, 2047, 5000], 0.0),
            "lengths above 2046, PAD": ([3, 150, 2047, 5000], 0.1)}[name]
        _, lengths = _rows(rng, 400, 1, lens, pad_share)
        return tdev._sort_hist_plain(None, torch.from_numpy(lengths),
                                     None), 0, tdev._HASH_FIRST
    if name.startswith("hash key"):
        words, lengths = _rows(rng, 800, 10, [150, 151])
        keys = tdev._row_hash_plain(from_numpy_u32(words),
                                    torch.from_numpy(lengths), 0)
        part = tdev._HASH_FIRST if name == "hash key, first family" \
            else tdev._HASH_NEXT
        return tdev._sort_hist_plain(
            None, torch.from_numpy(lengths) if part == tdev._HASH_FIRST
            else None, keys), 0, part
    if name == "every key equal":
        words = np.tile(np.array([[7, 0x80000001]], np.uint32), (300, 1))
        lengths = np.full(300, 31, np.int32)
    elif name == "every key equal, hash key":
        keys = torch.full((300,), -5, dtype=torch.int64)
        return tdev._sort_hist_plain(None, torch.full((300,), 150,
                                                       dtype=torch.int32),
                                     keys), 0, tdev._HASH_FIRST
    elif name == "constant lane digits":
        words, lengths = _rows(rng, 600, 2, range(10, 17))
        words[:, 1] = 0
    else:   # "W = w"
        w = int(name.split()[-1])
        words, lengths = _rows(rng, 700, w, [0, 3, 16, 150, 1024, 3000],
                               0.1)
    return tdev._sort_hist_plain(from_numpy_u32(words),
                                 torch.from_numpy(lengths), None), \
        words.shape[1], tdev._KEY_PATH


HIST_CASES = ["lengths below 256", "lengths below 256, PAD",
              "lengths up to 1024, PAD", "lengths above 2046",
              "lengths above 2046, PAD", "every key equal",
              "every key equal, hash key", "constant lane digits",
              "W = 1", "W = 2", "W = 5", "W = 6", "W = 64",
              "hash key, first family", "hash key, later family"]


def _table_sorts(hist, w, part):
    """The pass table of one call split by its sorts: (columns, the
    sort's rows of the table, whether its result is the permutation)."""
    table = tdev._sort_table_plain(hist, w, part)
    sorts, at = [], 0
    columns = tdev._sort_columns(w, part)
    for i, cols in enumerate(columns):
        count = len(tdev._candidates(cols))
        sorts.append((cols, table[at:at + count], i == len(columns) - 1))
        at += count
    assert at == len(table)
    return sorts


@pytest.mark.parametrize("name", HIST_CASES)
def test_pass_table_keeps_the_plans_digits(name):
    """The table's varying candidates, in order, are _sort_plan's digits;
    an empty plan leaves one copy entry, the sort's last candidate."""
    hist, w, part = _hist_case(name)
    for cols, rows, _ in _table_sorts(hist, w, part):
        cands = tdev._candidates(cols)
        plan = tdev._sort_plan(hist.numpy(), w, cols).tolist()
        kept = [list(cands[i]) for i, r in enumerate(rows.tolist())
                if r[0] == tdev._PASS]
        assert kept == plan
        modes = rows[:, 0].tolist()
        if plan:
            assert tdev._COPY not in modes
            assert [r[1] for r in rows.tolist() if r[0] == tdev._PASS] \
                == list(range(len(plan)))
        else:
            assert modes == [tdev._SKIP] * (len(cands) - 1) + [tdev._COPY]


@pytest.mark.parametrize("name", HIST_CASES)
def test_pass_table_matches_the_host_loop(name):
    """Each varying digit reads, writes, gathers and outputs as the host
    loop queued it: pass k reads half (k - 1) % 2 (k = 0: the input
    order) and writes half k % 2, gathers when its column's first, and
    carries, writes indices, or gives the result.  The one change: a
    length sort whose result is an order (the hash path's first family)
    writes it to a fixed array, not to half (passes - 1) % 2."""
    hist, w, part = _hist_case(name)
    for cols, rows, result in _table_sorts(hist, w, part):
        plan = tdev._sort_plan(hist.numpy(), w, cols)
        steps, _ = _host_loop(plan, result)
        got = [r for r in rows.tolist() if r[0] == tdev._PASS]
        assert len(got) == len(steps)
        for (_, k, gather, out), (src, dst, first, old_out) in \
                zip(got, steps):
            assert (None if k == 0 else (k + 1) % 2, k % 2) == (src, dst)
            assert bool(gather) == first
            last = k == len(steps) - 1
            want = tdev._RESULT if last else \
                (tdev._INDICES if old_out == 1 else tdev._CARRY)
            assert out == want
            if last:
                assert old_out == (1 if not result else
                                   3 if cols == [KEY] else 2)


@pytest.mark.parametrize("w", [1, 2, 3, 5, 6, 64])
def test_candidates_count_as_the_card_does(w):
    """cand_count in csrc/sort.cu: 8 digits a lane pair, 4 for a lone
    lane 0, 6 for the length (2 mapped, 4 as int32)."""
    cands = tdev._candidates(tdev._key_path_columns(w))
    assert len(cands) == 8 * (w // 2) + 4 * (w % 2) + 6
    assert cands[-6:] == [(MAPPED, 0), (MAPPED, 8)] \
        + [(FULL, 8 * b) for b in range(4)]


def test_card_operands_refuse_rows_over_64_lanes():
    """The plan launch holds a sort's candidates in shared memory sized
    for 64 lanes (reads of 1024 nt): wider rows raise before a launch."""
    lengths = torch.zeros(3, dtype=torch.int32)
    tdev._check_sort_operands(torch.zeros((3, 64), dtype=torch.int32),
                              lengths)
    with pytest.raises(ValueError, match="at most 64 lanes"):
        tdev._check_sort_operands(torch.zeros((3, 65), dtype=torch.int32),
                                  lengths)


def test_histograms_hold_both_length_digit_sets():
    """The int32 length's digits are counted whatever the flag (the card
    counts them in the one launch), and its low byte's bins are the
    mapped length's."""
    lengths = torch.tensor([3, 150, PAD, 1024, 17], dtype=torch.int32)
    hist = tdev._sort_hist_plain(None, lengths, None).view(-1)[:-1] \
        .view(-1, 256)
    full = [tdev._digit_slot(FULL, 8 * b, 0) for b in range(4)]
    mapped = tdev._digit_slot(MAPPED, 0, 0)
    assert torch.equal(hist[full[0]], hist[mapped])
    assert int(hist[full[3]].sum()) == 5


# -- the key path -------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(n for n, (w, _) in EDGE_CASES.items()
                                        if w.shape[1] <= 6))
def test_sort_rows_plain_edge_cases_match_lexsort(name):
    words, lengths = EDGE_CASES[name]
    perm = tdev.sort_rows_plain(from_numpy_u32(words),
                                torch.from_numpy(lengths))
    np.testing.assert_array_equal(perm.numpy(), _lexsort(words, lengths))


@pytest.mark.parametrize("w", [1, 2, 5, 6])
def test_sort_rows_plain_matches_lexsort_and_jax(w):
    # Lanes with bit 31 set or clear, PAD rows, lengths 0 and 1024, and
    # keys drawn from a small pool (equal keys keep their input order).
    rng = np.random.default_rng(20 + w)
    pool, pool_len = _rows(rng, 40, w, [0, 3, 16, 150, 1024], 0.1)
    pool[::2] |= 0x80000000
    pick = rng.integers(0, 40, size=3000)
    words, lengths = pool[pick], pool_len[pick]
    perm = tdev.sort_rows_plain(from_numpy_u32(words),
                                torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(perm, _lexsort(words, lengths))
    s_len, s_words, _ = jdev._sort_rows_lex(
        jnp.asarray(words), jnp.asarray(lengths),
        jnp.zeros(len(lengths), jnp.int32))
    np.testing.assert_array_equal(lengths[perm], np.asarray(s_len))
    np.testing.assert_array_equal(words[perm], np.asarray(s_words))


@pytest.mark.parametrize("w", [1, 2, 3, 6])
def test_sort_rows_on_the_cpu_equals_the_library_sort(w):
    """A stable sort's permutation is unique: S's plan gives the one that
    unique_count's torch.sort path gave before it."""
    rng = np.random.default_rng(30 + w)
    words, lengths = _rows(rng, 2000, w, [5, 16, 17, 96, 2047, 3000], 0.05)
    words[::3] = words[0]
    wt, lt = from_numpy_u32(words), torch.from_numpy(lengths)
    np.testing.assert_array_equal(tdev.sort_rows(wt, lt).numpy(),
                                  sort_rows_library(wt, lt).numpy())


# -- the hash path -------------------------------------------------------------


def _hash_rows(w, seed, n=1500, keys=120):
    rng = np.random.default_rng(seed)
    pool, pool_len = _rows(rng, keys, w, [97, 150, 151, 300], 0.05)
    pick = rng.integers(0, keys, size=n)
    return pool[pick], pool_len[pick]


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("w", [7, 10, 64])
def test_hash_order_plain_matches_jax(w, seed):
    """(s_hash, perm) in (h1, h2, length) order: the keys equal JAX's in
    JAX's sorted order, and perm is numpy's stable order.  Were the top
    bit of the key not flipped back, every h1 at or above 2^31 would sort
    first and both would differ."""
    words, lengths = _hash_rows(w, 40 + w)
    wt, lt = from_numpy_u32(words), torch.from_numpy(lengths)
    s_hash, perm = tdev._hash_order_plain(
        wt, lt, seed, tdev._length_order_plain(lt))
    keys, h1, h2 = _jax_keys(words, lengths, seed)
    assert (h1 >= 2**31).any() and (h1 < 2**31).any()
    want = np.lexsort([lengths, h2, h1])
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(s_hash.numpy(), keys[want])
    if seed == 0:   # JAX's first family, with no collision in these rows
        s_len, s_words, _, collision = jdev._sort_rows_hash(
            jnp.asarray(words), jnp.asarray(lengths),
            jnp.zeros(len(lengths), jnp.int32))
        assert not bool(collision)
        np.testing.assert_array_equal(lengths[want], np.asarray(s_len))
        np.testing.assert_array_equal(words[want], np.asarray(s_words))


@pytest.mark.parametrize("name", sorted(n for n, (w, _) in EDGE_CASES.items()
                                        if w.shape[1] > 6))
def test_hash_order_plain_edge_cases_match_lexsort(name):
    words, lengths = EDGE_CASES[name]
    wt, lt = from_numpy_u32(words), torch.from_numpy(lengths)
    by_length = tdev._length_order_plain(lt)
    if by_length is None:
        assert len(set(lengths.tolist())) == 1
    s_hash, perm = tdev._hash_order_plain(wt, lt, 0, by_length)
    keys, h1, h2 = _jax_keys(words, lengths, 0)
    want = np.lexsort([lengths, h2, h1])
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(s_hash.numpy(), keys[want])


@pytest.mark.parametrize("w", [7, 64])
def test_first_family_sorts_lengths_with_its_keys(w):
    """_sort_keys with the lengths (the first hash family) equals a sort
    from the plain length order, and returns that order for the next."""
    words, lengths = _hash_rows(w, 60 + w)
    wt, lt = from_numpy_u32(words), torch.from_numpy(lengths)
    keys = tdev._row_hash(wt, lt, 1)
    s_hash, perm, by_length = tdev._sort_keys(keys, lt)
    want = tdev._length_order_plain(lt)
    np.testing.assert_array_equal(by_length.numpy(), want.numpy())
    s_hash2, perm2, _ = tdev._sort_keys(keys, None, by_length)
    np.testing.assert_array_equal(perm.numpy(), perm2.numpy())
    np.testing.assert_array_equal(s_hash.numpy(), s_hash2.numpy())


def test_length_order_plain_is_the_stable_length_order():
    rng = np.random.default_rng(6)
    lengths = rng.choice(np.array([0, 150, 1024, PAD, 3000], np.int32),
                         size=700)
    order = tdev._length_order_plain(torch.from_numpy(lengths))
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(lengths, kind="stable"))
    assert tdev._length_order_plain(torch.full((9,), 150)) is None


def test_hash_order_equals_the_library_sorts():
    """_hash_order gives what the two stable torch.sorts gave before S."""
    words, lengths = _hash_rows(12, 7)
    wt, lt = from_numpy_u32(words), torch.from_numpy(lengths)
    keys = tdev._row_hash(wt, lt, 3)
    by_length = torch.sort(lt, stable=True).indices
    want_hash, order = torch.sort(keys[by_length], stable=True)
    s_hash, perm = tdev._hash_order(wt, lt, 3)
    np.testing.assert_array_equal(perm.numpy(), by_length[order].numpy())
    np.testing.assert_array_equal(s_hash.numpy(), want_hash.numpy())


# -- the card --------------------------------------------------------------------


def test_identity_length_order_means_the_input_order():
    """On the card _sort_keys returns the identity as the length order
    when every row has one length (no host read decides it); the plain
    version returns None.  unique_count passes either to the next family,
    and both give the same sort."""
    words, lengths = _hash_rows(9, 11)
    lengths[:] = 150
    wt, lt = from_numpy_u32(words), torch.from_numpy(lengths)
    keys = tdev._row_hash(wt, lt, 2)
    assert tdev._sort_keys(keys, lt)[2] is None
    ident = torch.arange(len(lengths), dtype=torch.int32)
    for got, want in zip(tdev._sort_keys(keys, None, ident)[:2],
                         tdev._sort_keys(keys, None, None)[:2]):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_kernel_s_matches_plain_on_card(cuda):
    """Kernel S's histograms, pass table, permutation, sorted keys and
    length order equal their plain versions on every edge case, tile
    counts around the card's resident blocks included (chip_smoke.py
    kernel_s runs this and the main path's shapes on the card)."""
    resident = tdev._build.cuda_lib().ssq_sort_resident_blocks(1)
    for name, words, lengths in sort_edge_cases(tdev.SORT_TILE_ROWS,
                                                resident):
        _card_case(cuda, name, words, lengths)


def _card_case(cuda, name, words, lengths):
    wt = from_numpy_u32(words).to(cuda)
    lt = torch.from_numpy(lengths).to(cuda)
    n, w = words.shape
    if w <= 6:
        run = tdev._sort_launch(wt, lt, None, None, tdev._KEY_PATH, n)
        hist = tdev._sort_hist_plain(wt, lt, None)
        assert torch.equal(run.hist, hist), name
        assert torch.equal(run.table.cpu(), tdev._sort_table_plain(
            hist.cpu(), w, tdev._KEY_PATH)), name
        assert torch.equal(run.perm, tdev.sort_rows_plain(wt, lt)), name
        assert torch.equal(tdev.sort_rows(wt, lt), run.perm), name
        return
    keys = tdev._row_hash(wt, lt, 0)
    run = tdev._sort_launch(None, lt, keys, None, tdev._HASH_FIRST, n)
    hist = tdev._sort_hist_plain(None, lt, keys)
    assert torch.equal(run.hist, hist), name
    assert torch.equal(run.table.cpu(), tdev._sort_table_plain(
        hist.cpu(), 0, tdev._HASH_FIRST)), name
    s_hash, perm, by_length = tdev._sort_keys(keys, lt)
    plain = tdev._length_order_plain(lt)
    want = torch.arange(n, device=cuda) if plain is None else plain
    assert torch.equal(by_length.long(), want), name
    for got, want in zip((s_hash, perm), tdev._sort_keys_plain(keys, lt)[:2]):
        assert torch.equal(got, want), name
    for got, want in zip(tdev._sort_keys(keys, None, by_length)[:2],
                         tdev._sort_keys_plain(keys, None, plain)[:2]):
        assert torch.equal(got, want), name
