"""shortseq_torch's unique_count (torch.sort + kernel D's plain version on
the CPU) against shortseq_tpu.count.device.unique_count on the same
inputs.  Mirrors tests/test_count_device.py:45-210 and the wrap and n_out
cases of tests/test_advice_fixes.py.

For W <= 6 the two packages sort the same way, so every output array must
be identical (so the edge cases of kernel D's tiles, built from
GROUP_TILE_ROWS, are held at W <= 6); for W > 6 the JAX package groups by a seeded row hash, so
its table is in hash order and the live prefixes are compared as
row-sorted arrays.

No counterpart: test_hash_collision_retries_to_exact and
test_hash_exhaustion_poisons_loudly (the port's radix sort is exact at
every width, so it has no hash path, no retry loop and no exhaustion
poison), and TestShardedCount (the sharded count comes with the dist
slice).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shortseq_tpu.count.device as jdev
import shortseq_torch.count.device as tdev
from shortseq_torch.ops.lanes import from_numpy_u32
from shortseq_torch.oracle import blocks_to_lanes, encode_bytes

PAD = tdev.PAD_LENGTH
ALPHA = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _rand_seqs(rng, n, lo, hi):
    lens = rng.integers(lo, hi + 1, size=n)
    return [ALPHA[rng.integers(0, 4, size=int(k))].tobytes().decode()
            for k in lens]


def _pack(seqs, lanes):
    """Strings -> (words [N, lanes] uint32, lengths [N] int32) through the
    scalar oracle, independent of both packages' device code."""
    words = np.zeros((len(seqs), lanes), np.uint32)
    for i, s in enumerate(seqs):
        words[i] = blocks_to_lanes(encode_bytes(s.encode()), lanes)
    return words, np.array([len(s) for s in seqs], np.int32)


def _both(words, lengths, weights=None, n_out=None):
    """unique_count of both packages -> two lists of numpy arrays
    (words as uint32, lengths, counts, n_unique)."""
    if weights is None:
        weights = np.ones(len(lengths), np.int32)
    weights = np.asarray(weights, np.int32)
    j = jdev.unique_count(jnp.asarray(words), jnp.asarray(lengths),
                          jnp.asarray(weights), n_out=n_out)
    t = tdev.unique_count(from_numpy_u32(words), torch.from_numpy(lengths),
                          torch.from_numpy(weights), n_out=n_out)
    j = [np.asarray(x) for x in j]
    t = [t[0].numpy().view(np.uint32)] + [x.numpy() for x in t[1:]]
    return j, t


def _assert_exact(j, t):
    assert len(j) == len(t) == 4
    for a, b in zip(j, t):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.int64),
                                      np.asarray(b, np.int64))


def _live_sorted(table):
    w, l, c, n = table
    n = int(n)
    rows = np.concatenate([l[:n, None].astype(np.int64),
                           w[:n].astype(np.int64),
                           c[:n, None].astype(np.int64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _assert_same_rows(j, t):
    assert int(j[3]) == int(t[3])
    np.testing.assert_array_equal(_live_sorted(j), _live_sorted(t))
    n = int(t[3])
    assert (t[1][n:] == PAD).all() and (t[2][n:] == 0).all()


def _assert_match(j, t, lanes):
    (_assert_exact if lanes <= 6 else _assert_same_rows)(j, t)


def test_exact_counts_small():
    rng = np.random.default_rng(0)
    seqs = _rand_seqs(rng, 64, 1, 32)
    seqs += seqs[:17]
    j, t = _both(*_pack(seqs, 2))
    _assert_exact(j, t)
    assert dict(zip(_decoded(t), t[2][:int(t[3])].tolist())) == \
        dict(collections.Counter(seqs))


def _decoded(t):
    from shortseq_torch.oracle import decode_blocks

    out = []
    for (length, blocks), _ in tdev.counts_to_host(
            from_numpy_u32(t[0]), torch.from_numpy(t[1]),
            torch.from_numpy(t[2]), int(t[3])):
        out.append(decode_blocks(blocks, length))
    return out


def test_same_prefix_different_length():
    seqs = ["ACGT", "ACGTACGT", "ACGT", "A", "AA", "A"]
    j, t = _both(*_pack(seqs, 2))
    _assert_exact(j, t)
    assert dict(zip(_decoded(t), t[2][:int(t[3])].tolist())) == \
        {"ACGT": 2, "ACGTACGT": 1, "A": 2, "AA": 1}


def test_weights_merge_associative():
    rng = np.random.default_rng(1)
    a = _rand_seqs(rng, 32, 20, 20)
    b = a[:10] + _rand_seqs(rng, 22, 20, 20)
    ja, ta = _both(*_pack(a, 2))
    jb, tb = _both(*_pack(b, 2))
    _assert_exact(ja, ta)
    _assert_exact(jb, tb)
    cat = [np.concatenate([x, y]) for x, y in zip(ta[:3], tb[:3])]
    j, t = _both(*cat)
    _assert_exact(j, t)
    assert dict(zip(_decoded(t), t[2][:int(t[3])].tolist())) == \
        dict(collections.Counter(a) + collections.Counter(b))


def test_pad_rows_excluded():
    words = np.zeros((8, 2), np.uint32)
    lengths = np.array([4, 4, PAD, PAD, 4, 8, 8, PAD], np.int32)
    j, t = _both(words, lengths)
    _assert_exact(j, t)
    assert int(t[3]) == 2
    assert t[1][0] == 4 and t[2][0] == 3
    assert t[1][1] == 8 and t[2][1] == 2
    assert (t[2][2:] == 0).all()


def test_dead_rows_with_stale_words_split_into_pad_groups():
    # Dead rows keep whatever words they held: they sort last, may form
    # several trailing pad groups, and still count nothing.
    words = np.array([[5, 0], [1, 0], [7, 9], [1, 0], [3, 3], [5, 0]],
                     np.uint32)
    lengths = np.array([8, 8, PAD, 8, PAD, PAD], np.int32)
    j, t = _both(words, lengths, weights=[1, 2, 9, 3, -4, 7])
    _assert_exact(j, t)
    assert int(t[3]) == 2
    assert t[2][:2].tolist() == [5, 1]


@pytest.mark.parametrize("lanes,lo,hi", [(1, 0, 16), (2, 0, 32),
                                         (3, 17, 48), (6, 33, 96),
                                         (8, 97, 128), (64, 97, 300)])
def test_widths_match_jax(lanes, lo, hi):
    rng = np.random.default_rng(lanes)
    seqs = _rand_seqs(rng, 60, lo, hi)
    seqs += seqs[::3]
    words, lengths = _pack(seqs, lanes)
    perm = rng.permutation(len(seqs))
    j, t = _both(words[perm], lengths[perm])
    _assert_match(j, t, lanes)


@pytest.mark.parametrize("lanes", [1, 2, 5, 6, 64])
def test_sort_rows_is_stable_unsigned_lex(lanes):
    # Lanes with bit 31 set must sort after those without (unsigned), and
    # equal keys keep their input order.
    rng = np.random.default_rng(10 + lanes)
    pool = rng.integers(0, 2**32, size=(12, lanes), dtype=np.uint64) \
        .astype(np.uint32)
    pick = rng.integers(0, 12, size=200)
    words = pool[pick]
    lengths = rng.choice(np.array([3, 16, PAD], np.int32), size=200)
    perm = tdev.sort_rows(from_numpy_u32(words), torch.from_numpy(lengths))
    keys = [words[:, k] for k in range(lanes - 1, -1, -1)] + [lengths]
    np.testing.assert_array_equal(perm.numpy(), np.lexsort(keys))


@pytest.mark.parametrize("weights", [[5, -1, 2, 2], [1, -1, 2, 2],
                                     [5, -5, 2, 2]],
                         ids=["minus-one", "cancel-one", "cancel-to-zero"])
def test_poison_closed_under_merge(weights):
    words = np.array([[1, 0], [1, 0], [2, 0], [3, 0]], np.uint32)
    lengths = np.full(4, 16, np.int32)
    j, t = _both(words, lengths, weights=weights)
    _assert_exact(j, t)
    assert (t[2][:int(t[3])] == -1).all()
    with pytest.raises(OverflowError):
        tdev.counts_to_host(*(torch.from_numpy(np.asarray(x))
                              for x in (t[0].view(np.int32), *t[1:])))


@pytest.mark.parametrize("weights,want", [
    ([1_900_000_000] * 3, -1),      # wraps to +1_405_032_704 in int32
    ([2_000_000_000] * 2, -1),      # wraps negative
    ([1_000_000_000] * 2, 2_000_000_000),
])
def test_int32_wrap_reads_minus_one(weights, want):
    words = np.zeros((len(weights), 2), np.uint32)
    words[:, 0] = 0x78
    lengths = np.full(len(weights), 4, np.int32)
    j, t = _both(words, lengths, weights=weights)
    _assert_exact(j, t)
    assert int(t[3]) == 1 and int(t[2][0]) == want
    table = [torch.from_numpy(t[0].view(np.int32))] + \
        [torch.from_numpy(x) for x in t[1:3]] + [int(t[3])]
    if want < 0:
        with pytest.raises(OverflowError):
            tdev.counts_to_host(*table)
    else:
        assert tdev.counts_to_host(*table)[0][1] == want


@pytest.mark.parametrize("n_out", [2, 3, 16])
def test_n_out(n_out):
    words = np.zeros((6, 2), np.uint32)
    words[:, 0] = [1, 2, 3, 1, 4, 2]
    lengths = np.full(6, 4, np.int32)
    j, t = _both(words, lengths, n_out=n_out)
    _assert_exact(j, t)
    assert int(t[3]) == 4  # n_unique reports the true group count
    table = [torch.from_numpy(t[0].view(np.int32))] + \
        [torch.from_numpy(x) for x in t[1:]]
    if n_out < 4:
        with pytest.raises(ValueError, match="n_out too small"):
            tdev.fetch_table(*table)
    else:
        assert tdev.fetch_table(*table)[2].tolist() == [2, 2, 1, 1]


@pytest.mark.parametrize("lanes,n_out", [(2, None), (6, 5)])
def test_empty_batch(lanes, n_out):
    j, t = _both(np.zeros((0, lanes), np.uint32), np.zeros(0, np.int32),
                 n_out=n_out)
    _assert_exact(j, t)
    assert int(t[3]) == 0 and (t[1] == PAD).all()


@pytest.mark.parametrize("n_unique", [1, 255, 256, 257, 300])
def test_fetch_table_prefix(n_unique):
    n = 1024
    words = (np.arange(n, dtype=np.uint32) % n_unique).reshape(n, 1)
    lengths = np.full(n, 16, np.int32)
    j, t = _both(words, lengths)
    want = jdev.fetch_table(*(jnp.asarray(x) for x in j))
    got = tdev.fetch_table(torch.from_numpy(t[0].view(np.int32)),
                           *(torch.from_numpy(x) for x in t[1:]))
    assert got[3] == want[3] == n_unique
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[0].dtype == np.uint32 and int(got[2].sum()) == n


def test_merge_host_tuples_carries_jax_tables():
    """Count tables fetched from shortseq_tpu (numpy uint32 words, int32
    lengths and counts, as dist/pipeline._table_to_host returns them)
    merge on the port's device exactly as the JAX package merges them."""
    from shortseq_tpu.count.checkpoint import \
        merge_host_tuples as jax_merge
    from shortseq_tpu.dist.pipeline import _table_to_host
    from shortseq_torch.count.checkpoint import merge_host_tuples

    rng = np.random.default_rng(4)
    pool = _rand_seqs(rng, 40, 0, 32) + _rand_seqs(rng, 20, 33, 90)
    host_tables = []
    for part in range(3):
        seqs = [pool[i] for i in rng.integers(0, len(pool), size=150)]
        lanes = 2 if part < 2 else 6
        seqs = [s for s in seqs if len(s) <= 16 * lanes]
        words, lengths = _pack(seqs, lanes)
        host_tables.append(_table_to_host(jdev.count_batch(
            jnp.asarray(words), jnp.asarray(lengths))))
    want = jdev.fetch_table(*jax_merge(host_tables))
    got = tdev.fetch_table(*merge_host_tuples(host_tables, device="cpu"))
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    empty = merge_host_tuples([], device="cpu")
    assert int(empty[3]) == 0 and int(empty[1][0]) == PAD


@pytest.mark.parametrize("n_out", [3, 29, 40, 500])
def test_merge_host_tuples_n_out_matches_jax(n_out):
    """n_out reaches unique_count as in the JAX package: below the group
    count (3 and 29 of 30 groups) the first n_out groups are kept and
    n_unique still counts them all; above it the rows past n_unique are
    padding.  Every output array is compared (W <= 6)."""
    from shortseq_tpu.count.checkpoint import \
        merge_host_tuples as jax_merge
    from shortseq_torch.count.checkpoint import merge_host_tuples

    rng = np.random.default_rng(9)
    pool = list(dict.fromkeys(_rand_seqs(rng, 30, 10, 32)))
    assert len(pool) == 30
    host_tables = []
    for part in range(3):
        seqs = [pool[i] for i in rng.integers(0, len(pool), size=60)]
        words, lengths = _pack(seqs, 2)
        host_tables.append((words, lengths,
                            rng.integers(1, 5, size=60).astype(np.int32)))
    host_tables.append(_pack(pool, 2) + (np.ones(30, np.int32),))
    want = jax_merge(host_tables, n_out=n_out)
    got = merge_host_tuples(host_tables, n_out=n_out, device="cpu")
    assert int(got[3]) == int(want[3]) == 30
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy().view(np.asarray(w).dtype),
                                      np.asarray(w))
    if n_out < 30:
        with pytest.raises(ValueError, match="n_out too small"):
            tdev.fetch_table(*got)


def test_merge_host_tuples_and_empty_table_default_to_the_card():
    """Like every entry point of the port, both default to device="cuda"
    and raise without a card."""
    from shortseq_torch.count.checkpoint import (empty_table,
                                                 merge_host_tuples)

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works there")
    table = _pack(["ACGT"], 2) + (np.ones(1, np.int32),)
    for call in (lambda: merge_host_tuples([table]),
                 lambda: merge_host_tuples([], n_out=4),
                 lambda: empty_table(2)):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            call()


TILE = tdev.GROUP_TILE_ROWS


def _ordered_groups(sizes, lanes, seed, live=True):
    """Rows of len(sizes) groups of the given sizes, shuffled.  Lane 0
    numbers the groups, so the sort puts them in the order of `sizes` and
    their edges fall where the sizes put them (kernel D's tile edges)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**32, size=(len(sizes), lanes),
                        dtype=np.uint64).astype(np.uint32)
    keys[:, 0] = np.arange(len(sizes))
    rows = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
    return keys[rows], np.full(len(rows), 16 if live else PAD, np.int32)


#: Kernel D's edge cases: name -> (sizes of the groups in sorted order,
#: live?).  The sizes come from the tile's row count.
EDGE_CASES = {
    "one-group-of-5000": ([5000], True),
    "tile-1,tile,tile+1": ([TILE - 1, TILE, TILE + 1, 7], True),
    "mid-tile-across-tiles": ([TILE // 2, 2 * TILE + TILE // 2 + 3, 7],
                              True),
    "all-pad-stale-words": ([TILE, 4, TILE + 3], False),
    "n-1": ([1], True),
    "n-1-pad": ([1], False),
}


def _edge_case(name, lanes):
    """(words, lengths, weights) of one EDGE_CASES entry; weights are
    small and positive on live rows, anything on dead ones."""
    sizes, live = EDGE_CASES[name]
    words, lengths = _ordered_groups(sizes, lanes, seed=lanes, live=live)
    rng = np.random.default_rng(lanes)
    lo = 1 if live else -3
    return words, lengths, rng.integers(lo, 5, size=len(lengths)) \
        .astype(np.int32)


@pytest.mark.parametrize("lanes", [1, 5, 6])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_tile_edge_groups_match_jax(case, lanes):
    words, lengths, weights = _edge_case(case, lanes)
    j, t = _both(words, lengths, weights)
    _assert_exact(j, t)
    sizes, live = EDGE_CASES[case]
    assert int(t[3]) == (len(sizes) if live else 0)
    if live:
        want = [int(weights[words[:, 0] == g].sum())
                for g in range(len(sizes))]
        assert t[2][:len(sizes)].tolist() == want


def test_length_only_groups_across_tiles_match_jax():
    # Equal words, groups told apart by length alone, edges on and next
    # to the tile edges.
    lengths = np.repeat(np.array([4, 5, 6, 7], np.int32),
                        [TILE - 1, TILE + 1, TILE, 3])
    j, t = _both(np.zeros((len(lengths), 2), np.uint32), lengths)
    _assert_exact(j, t)
    assert t[2][:4].tolist() == [TILE - 1, TILE + 1, TILE, 3]


def test_kernel_d_matches_plain_on_card(cuda):
    def check(words, lengths, weights, n_out=None):
        words = from_numpy_u32(words).to(cuda)
        lengths = torch.from_numpy(lengths).to(cuda)
        weights = torch.from_numpy(np.asarray(weights, np.int32)).to(cuda)
        n_out = len(lengths) if n_out is None else n_out
        perm = tdev.sort_rows(words, lengths)
        before = tdev.group_count.launches
        got = tdev.group_count(words, lengths, weights, perm, n_out)
        assert tdev.group_count.launches == before + 1
        want = tdev.group_count_plain(words, lengths, weights, perm, n_out)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    rng = np.random.default_rng(5)
    for lanes, n, keys in ((2, 100_000, 30_000), (6, 50_000, 1_000),
                           (64, 20_000, 300)):
        pool = rng.integers(0, 2**32, size=(keys, lanes),
                            dtype=np.uint64).astype(np.uint32)
        check(pool[rng.integers(0, keys, size=n)],
              rng.choice(np.array([7, 32, PAD], np.int32), size=n),
              rng.integers(0, 5, size=n))
    for lanes in (1, 2, 5, 6, 64):
        for case in EDGE_CASES:
            check(*_edge_case(case, lanes))
    lengths = np.repeat(np.array([4, 5, 6, 7], np.int32),
                        [TILE - 1, TILE + 1, TILE, 3])
    check(np.zeros((len(lengths), 2), np.uint32), lengths,
          np.ones(len(lengths)))
    words = np.array([[1, 0], [1, 0], [2, 0], [3, 0]], np.uint32)
    check(words, np.full(4, 16, np.int32), [5, -5, 2, 2])
    for weights in ([1_900_000_000] * 3, [2_000_000_000] * 2,
                    [-2_000_000_000] * 2):
        check(np.full((len(weights), 2), 0x78, np.uint32),
              np.full(len(weights), 4, np.int32), weights)
    words, lengths = _ordered_groups([TILE + 5], 2, seed=7)
    check(words, lengths, np.full(len(lengths), 1_100_000))
    words, lengths = _ordered_groups([3] * 1500 + [TILE + 2], 2, seed=8)
    for n_out in (1, 1000):
        check(words, lengths, np.ones(len(lengths)), n_out=n_out)


def test_counts_to_host_scattered_matches_jax():
    # Live rows interleaved with PAD rows, as a bucketed exchange leaves
    # its per-device compact tables.
    rng = np.random.default_rng(6)
    words, lengths = _pack(_rand_seqs(rng, 40, 0, 32), 2)
    lengths[rng.random(40) < 0.3] = PAD
    counts = rng.integers(1, 9, size=40).astype(np.int32)
    want = jdev.counts_to_host_scattered(
        jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(counts))
    got = tdev.counts_to_host_scattered(
        from_numpy_u32(words), torch.from_numpy(lengths),
        torch.from_numpy(counts))
    assert got == want and len(got) == int((lengths != PAD).sum())
