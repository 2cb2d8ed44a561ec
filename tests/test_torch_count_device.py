"""shortseq_torch's unique_count (the plain versions of kernels S, D and
I on the CPU) against shortseq_tpu.count.device.unique_count
on the same inputs.  Mirrors tests/test_count_device.py:45-210 and the
wrap and n_out cases of tests/test_advice_fixes.py.

Both packages sort rows of up to 6 lanes by key and wider rows by the
seeded row hash, so every output array must be identical at every width
(the edge cases of kernel D's tiles, built from GROUP_TILE_ROWS, at
W <= 6; the hash path at W = 7, 8, 10 and 64).  The row hash itself
(_row_hash_plain) is held to JAX's _row_hash with its PAD forcing, the
hash path's retry and exhaustion poison are held as the JAX tests hold
them (a monkeypatched _row_hash), and kernel D's collision word to the
edge cases that chip_smoke.collision_cases builds.

No counterpart: TestShardedCount (tests/test_torch_dist.py holds the
sharded count).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shortseq_tpu.count.device as jdev
import shortseq_torch.count.device as tdev
from chip_smoke import PAD_KEY, collision_cases
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
    _assert_exact(j, t)


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


@pytest.mark.parametrize("lanes,n_out", [(2, None), (6, 5), (8, None),
                                         (64, 3)])
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


# --- the hash path: rows over _LEX_SORT_MAX_LANES lanes ---------------------

HASH_WIDTHS = [7, 8, 10, 64]


def _jax_keys(words, lengths, seed):
    """JAX's _row_hash with _sort_rows_hash's PAD forcing, fused into
    kernel I's int64 key: ((int32)(h1 ^ 2^31)) << 32 | h2."""
    h1, h2 = jdev._row_hash(jnp.asarray(words), jnp.asarray(lengths),
                            jnp.int32(seed))
    live = lengths != PAD
    h1 = np.where(live, np.asarray(h1), np.uint32(0xFFFFFFFF))
    h2 = np.where(live, np.asarray(h2), np.uint32(0xFFFFFFFF))
    hi = (h1 ^ np.uint32(0x80000000)).view(np.int32).astype(np.int64)
    return (hi << 32) | h2.astype(np.int64)


def _wide_rows(lanes, seed, n=240, keys=40):
    """n rows drawn from `keys` distinct ones with lanes of any 32 bits
    (the high bit set in about half), lengths 97-300, a fifth of the rows
    dead (PAD) with their stale words kept."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, size=(keys, lanes),
                        dtype=np.uint64).astype(np.uint32)
    pool_len = rng.integers(97, 301, size=keys).astype(np.int32)
    pick = rng.integers(0, keys, size=n)
    words, lengths = pool[pick], pool_len[pick]
    lengths[rng.random(n) < 0.2] = PAD
    return words, lengths


@pytest.mark.parametrize("lanes", HASH_WIDTHS)
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_row_hash_plain_matches_jax(seed, lanes):
    words, lengths = _wide_rows(lanes, 20 + seed)
    assert (words >= 2**31).any() and (lengths == PAD).any()
    got = tdev._row_hash_plain(from_numpy_u32(words),
                               torch.from_numpy(lengths), seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_keys(words, lengths, seed))
    # A CPU tensor takes the plain version through the wrapper.
    assert torch.equal(tdev._row_hash(from_numpy_u32(words),
                                      torch.from_numpy(lengths), seed), got)


@pytest.mark.parametrize("n_out", ["all", "below", "above"])
@pytest.mark.parametrize("weighted", [False, True], ids=["unit", "weights"])
@pytest.mark.parametrize("lanes", HASH_WIDTHS)
def test_hash_path_matches_jax(lanes, weighted, n_out):
    """unique_count at W > 6: every output array equals JAX's, the
    stale words of dead groups past n_unique included."""
    words, lengths = _wide_rows(lanes, lanes)
    rng = np.random.default_rng(lanes + 100)
    weights = rng.integers(0, 9, size=len(lengths)) if weighted else None
    groups = len({(int(l), w.tobytes())
                  for w, l in zip(words, lengths) if l != PAD})
    n_out = {"all": None, "below": groups // 2,
             "above": len(lengths) + 7}[n_out]
    j, t = _both(words, lengths, weights, n_out=n_out)
    _assert_exact(j, t)
    assert int(t[3]) == groups


@pytest.mark.parametrize("lanes", HASH_WIDTHS)
def test_sort_rows_hash_matches_jax(lanes):
    """_sort_rows_hash's 4-tuple: the same lengths and rows in the same
    order, and the same weights per group (the JAX sort need not keep
    equal rows in input order)."""
    words, lengths = _wide_rows(lanes, 30 + lanes)
    weights = np.arange(len(lengths), dtype=np.int32)
    j = [np.asarray(x) for x in jdev._sort_rows_hash(
        jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(weights))]
    t = tdev._sort_rows_hash(from_numpy_u32(words), torch.from_numpy(lengths),
                             torch.from_numpy(weights))
    t = [t[0].numpy(), t[1].numpy().view(np.uint32), t[2].numpy(),
         t[3].numpy()]
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[1], j[1])
    assert bool(t[3]) is bool(j[3]) is False
    head = np.ones(len(lengths), bool)
    head[1:] = (t[0][1:] != t[0][:-1]) | (t[1][1:] != t[1][:-1]).any(axis=1)
    seg = np.cumsum(head) - 1
    for g in range(seg[-1] + 1):
        assert sorted(t[2][seg == g]) == sorted(j[2][seg == g])


def _hash_rows(seed):
    rng = np.random.default_rng(seed)
    seqs = _rand_seqs(rng, 20, 97, 128)
    seqs += seqs[::2]
    return seqs, *_pack(seqs, 8)


def test_hash_collision_retries_to_exact(monkeypatch):
    # A hash family that collides for the FIRST seed only: the retry must
    # draw the next one and the count come out exact, in the order of
    # JAX's table under the same patch.
    import jax

    real, jreal = tdev._row_hash, jdev._row_hash
    seeds = []

    def first_seed_collides(words, lengths, seed):
        seeds.append(seed)
        keys = real(words, lengths, seed)
        return torch.zeros_like(keys) if seed == 0 else keys

    def jax_first_seed_collides(words, lengths, seed):
        h1, h2 = jreal(words, lengths, seed)
        bad = seed == 0
        return (jnp.where(bad, jnp.zeros_like(h1), h1),
                jnp.where(bad, jnp.zeros_like(h2), h2))

    monkeypatch.setattr(tdev, "_row_hash", first_seed_collides)
    monkeypatch.setattr(jdev, "_row_hash", jax_first_seed_collides)
    seqs, words, lengths = _hash_rows(40)
    ones = np.ones(len(seqs), np.int32)
    *_, collision = tdev._sort_rows_hash(
        from_numpy_u32(words), torch.from_numpy(lengths),
        torch.from_numpy(ones))
    assert not bool(collision) and seeds == [0, 1]  # the retry recovered
    seeds.clear()
    with jax.disable_jit():
        j, t = _both(words, lengths)
    assert seeds == [0, 1]
    _assert_exact(j, t)
    assert dict(zip(_decoded(t), t[2][:int(t[3])].tolist())) == \
        dict(collections.Counter(seqs))


def test_hash_exhaustion_poisons_loudly(monkeypatch):
    # A degenerate hash that collides for EVERY seed (the adversarial
    # worst case) must never yield a silently mis-grouped table: the
    # counts come back poisoned and materialization raises.
    import jax

    seeds = []

    def degenerate(words, lengths, seed):
        seeds.append(seed)
        return torch.zeros(words.shape[0], dtype=torch.int64)

    def jax_degenerate(words, lengths, seed):
        n = lengths.shape[0]
        return jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32)

    monkeypatch.setattr(tdev, "_row_hash", degenerate)
    monkeypatch.setattr(jdev, "_row_hash", jax_degenerate)
    seqs, words, lengths = _hash_rows(41)
    ones = np.ones(len(seqs), np.int32)
    *_, collision = tdev._sort_rows_hash(
        from_numpy_u32(words), torch.from_numpy(lengths),
        torch.from_numpy(ones))
    assert bool(collision)  # every family exhausted
    assert seeds == list(range(tdev._HASH_MAX_TRIES))
    with jax.disable_jit():
        j, t = _both(words, lengths)
    _assert_exact(j, t)
    n = int(t[3])
    assert n > 0 and (t[2][:n] == -1).all() and (t[2][n:] == 0).all()
    with pytest.raises(OverflowError):
        tdev.counts_to_host(torch.from_numpy(t[0].view(np.int32)),
                            *(torch.from_numpy(x) for x in t[1:3]), n)


#: Kernel D's collision cases, as chip_smoke holds the kernel to them.
COLLISION_CASES = {c[0]: c[1:] for c in collision_cases(TILE)}


@pytest.mark.parametrize("case", sorted(COLLISION_CASES))
def test_collision_word_matches_jax(case, monkeypatch):
    """Kernel D's plain version flags exactly the pairs that JAX's
    _sort_rows_hash calls a collision, given the same keys (JAX's
    _row_hash patched to return them); the table is D's without keys."""
    import jax

    words, lengths, weights, keys, want = COLLISION_CASES[case]
    n = len(lengths)
    args = (from_numpy_u32(words), torch.from_numpy(lengths),
            torch.from_numpy(weights), torch.arange(n))
    got = tdev.group_count_plain(*args, n, torch.from_numpy(keys))
    assert got[4].dtype == torch.int64 and int(got[4]) == want
    for g, w in zip(got[:4], tdev.group_count_plain(*args, n)):
        assert torch.equal(g, w)
    h1 = ((keys >> 32).astype(np.uint32) ^ np.uint32(0x80000000))
    h2 = (keys & 0xFFFFFFFF).astype(np.uint32)
    monkeypatch.setattr(jdev, "_row_hash",
                        lambda w, l, s: (jnp.asarray(h1), jnp.asarray(h2)))
    with jax.disable_jit():
        *_, collision = jdev._sort_rows_hash(
            jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(weights))
    assert bool(collision) is bool(want)


def test_kernels_i_and_d_with_keys_match_plain_on_card(cuda):
    rng = np.random.default_rng(13)
    for lanes, n in ((7, 10_001), (8, 20_000), (10, 20_000), (64, 20_000)):
        words, lengths = _wide_rows(lanes, lanes, n=n, keys=300)
        words = from_numpy_u32(words).to(cuda)
        lengths = torch.from_numpy(lengths).to(cuda)
        # The same rows 4 bytes past a 16-byte boundary.
        off = torch.empty(n * lanes + 1, dtype=torch.int32,
                          device=cuda)[1:].view(n, lanes)
        off.copy_(words)
        for view in (words, off):
            for seed in (0, 7):
                before = tdev._row_hash.launches
                got = tdev._row_hash(view, lengths, seed)
                assert tdev._row_hash.launches == before + 1
                assert torch.equal(got,
                                   tdev._row_hash_plain(view, lengths, seed))
                assert (got[lengths == PAD] == PAD_KEY).all()
        weights = torch.from_numpy(rng.integers(1, 5, size=n)
                                   .astype(np.int32)).to(cuda)
        s_hash, perm = tdev._hash_order(words, lengths, 0)
        for g, w in zip(
                tdev.group_count(words, lengths, weights, perm, n, s_hash),
                tdev.group_count_plain(words, lengths, weights, perm, n,
                                       s_hash)):
            assert torch.equal(g, w)
    for words, lengths, weights, keys, want in COLLISION_CASES.values():
        args = [from_numpy_u32(words).to(cuda),
                torch.from_numpy(lengths).to(cuda),
                torch.from_numpy(weights).to(cuda),
                torch.arange(len(lengths), device=cuda)]
        got = tdev.group_count(*args, len(lengths),
                               torch.from_numpy(keys).to(cuda))
        assert int(got[4]) == want
        for g, w in zip(got, tdev.group_count_plain(
                *args, len(lengths), torch.from_numpy(keys).to(cuda))):
            assert torch.equal(g, w)
