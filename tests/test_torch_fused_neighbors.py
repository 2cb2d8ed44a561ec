"""Kernel H (shortseq_torch.umi.dedup.neighbor_lists_fused: neighbour
lists with no distance slab) against the JAX package's _adjacency_score +
_extract_ascending (shortseq_tpu/umi/dedup.py:180,203) on the same
numpy-seeded packed words, and _neighbor_lists, whose main pass it is,
against the JAX _neighbor_lists.  On the CPU the wrapper runs its plain
version; the card-only tests hold the kernel to that plain version.  Exact
comparisons (integer outputs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shortseq_torch.umi.dedup as td
import shortseq_tpu.umi.dedup as jd
from shortseq_torch.ops.lanes import from_numpy_u32
from chip_smoke import csr_rows

ALPHA = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _fans(u, w, seed, bases=2):
    """u columns of w lanes: error fans around a few random bases (0-2
    substituted fields each), so rows have many neighbours at threshold 3;
    lengths 12 with some 11 and some pad rows (-1), two group ids."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, size=(bases, w), dtype=np.uint64)
    words = base[rng.integers(0, bases, size=u)].astype(np.uint32)
    for _ in range(2):
        field = rng.integers(0, 16 * w, size=u)
        flip = rng.integers(0, 4, size=u).astype(np.uint32)
        lane, shift = field // 16, (2 * (field % 16)).astype(np.uint32)
        words[np.arange(u), lane] ^= flip << shift
    lengths = np.full(u, 12, np.int32)
    lengths[rng.random(u) < 0.1] = 11
    lengths[rng.random(u) < 0.05] = -1
    gids = (rng.random(u) < 0.2).astype(np.int32)
    return words, lengths, gids


def _queries(u, seed, r=None):
    """Query row ids: a shuffled subset of the columns (self exclusion is
    by these global ids)."""
    rng = np.random.default_rng(seed + 100)
    r = u if r is None else r
    return rng.choice(u, size=r, replace=False).astype(np.int32)


def _jax_lists(words, lengths, gids, rows, threshold, k):
    score, cnt = jd._adjacency_score(
        jnp.asarray(words[rows]), jnp.asarray(lengths[rows]),
        jnp.asarray(gids[rows]), jnp.asarray(rows), jnp.asarray(words),
        jnp.asarray(lengths), jnp.asarray(gids), threshold)
    return np.asarray(jd._extract_ascending(score, k)), np.asarray(cnt)


def _torch_args(words, lengths, gids, rows, device="cpu"):
    t = [from_numpy_u32(words[rows]), torch.from_numpy(lengths[rows]),
         torch.from_numpy(gids[rows]), torch.from_numpy(rows),
         from_numpy_u32(words), torch.from_numpy(lengths),
         torch.from_numpy(gids)]
    return [x.contiguous().to(device) for x in t]


@pytest.mark.parametrize("u", [1, 127, 128, 129])
@pytest.mark.parametrize("w", [1, 2])
@pytest.mark.parametrize("k", [16, 128])
def test_plain_matches_jax_extraction(u, w, k):
    words, lengths, gids = _fans(u, w, seed=u * 10 + w)
    rows = _queries(u, seed=u)
    want_idx, want_cnt = _jax_lists(words, lengths, gids, rows, 3, k)
    idx, cnt = td.neighbor_lists_fused(*_torch_args(words, lengths, gids,
                                                    rows), 3, k)
    assert idx.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(cnt.numpy(), want_cnt)
    if u > 100 and k == 16:
        assert (want_cnt > k).any()          # truncated rows, true counts
        assert (lengths == -1).any() and (want_cnt > 0).any()


@pytest.mark.parametrize("threshold", [0, 1, 2])
def test_plain_chunks_agree(threshold, monkeypatch):
    """The plain version's row chunks (1, 7 and 64 rows under a smaller
    distance budget) change nothing."""
    words, lengths, gids = _fans(300, 2, seed=threshold)
    args = _torch_args(words, lengths, gids, _queries(300, seed=5, r=77))
    want = td.neighbor_lists_fused(*args, threshold, 16)
    for step in (1, 7, 64):
        monkeypatch.setattr(td, "_PAIR_BUDGET", 300 * step)
        got = td.neighbor_lists_fused_plain(*args, threshold, 16)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_plain_handles_no_rows_and_rejects_bad_shapes():
    words, lengths, gids = _fans(10, 2, seed=1)
    args = _torch_args(words, lengths, gids, np.zeros(0, np.int32))
    idx, cnt = td.neighbor_lists_fused(*args, 1, 16)
    assert tuple(idx.shape) == (0, 16) and tuple(cnt.shape) == (0,)
    args = _torch_args(words, lengths, gids, _queries(10, seed=1))
    args[0] = args[0][:, :1]
    with pytest.raises(ValueError, match="neighbour operands"):
        td.neighbor_lists_fused(*args, 1, 16)


def _fan_umis(n_base, length, seed, reps=3):
    """Error fans of UMIs: n_base random UMIs, each followed by every one
    of its single-substitution variants (3 * length), so at threshold 2
    every row has about 3 * length neighbours, more than _NEIGHBOR_K."""
    rng = np.random.default_rng(seed)
    base = ALPHA[rng.integers(0, 4, size=(n_base, length))]
    out = []
    for b in base:
        out.extend([b.tobytes()] * reps)
        for pos in range(length):
            for c in ALPHA:
                if c != b[pos]:
                    v = b.copy()
                    v[pos] = c
                    out.append(v.tobytes())
    return list(dict.fromkeys(out))


@pytest.mark.parametrize("block", [None, 5, 64, 300])
def test_neighbor_lists_fans_match_jax(block):
    umis = _fan_umis(6, 8, seed=2)
    words, lengths = jd._pack_validate_umis(umis)
    words = np.asarray(words)
    gids = np.arange(len(umis)) // 25 % 2      # one group id per fan
    edges = td._neighbor_lists.edges
    nbrs = td._neighbor_lists(words, lengths, 2, gids=gids, block=block,
                              device="cpu")
    assert td._neighbor_lists.edges - edges == len(nbrs.indices)
    got = csr_rows(nbrs)
    want = jd._neighbor_lists(words, lengths, 2, gids=gids, block=block)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w_, np.int64))
    assert max(map(len, want)) > td._NEIGHBOR_K    # the overflow tier ran


def test_main_pass_writes_no_slab(monkeypatch):
    """With no row over k, _neighbor_lists never calls kernel B: its main
    pass is kernel H alone."""
    def no_slab(*a, **k):
        raise AssertionError("kernel B called in the main pass")

    monkeypatch.setattr(td, "hamming_pairwise_tiled", no_slab)
    words, lengths, gids = _fans(200, 2, seed=9, bases=50)
    edges = td._neighbor_lists.edges
    nbrs = td._neighbor_lists(words, np.full(200, 12), 1, device="cpu")
    assert td._neighbor_lists.edges - edges == len(nbrs.indices) > 0
    got = csr_rows(nbrs)
    assert max(map(len, got)) <= td._NEIGHBOR_K
    want = jd._neighbor_lists(words, np.full(200, 12), 1)
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w_, np.int64))


# --- on the card -------------------------------------------------------------


@pytest.mark.parametrize("u,r,w,k,threshold", [
    (129, 129, 2, 16, 3), (5000, 5000, 2, 16, 3), (5000, 300, 1, 128, 3),
    (20000, 20000, 2, 16, 1), (3000, 1, 2, 16, 3), (1, 1, 2, 1, 0),
    (70000, 2000, 2, 128, 2)])
def test_kernel_matches_plain_on_card(cuda, u, r, w, k, threshold):
    words, lengths, gids = _fans(u, w, seed=u + r, bases=max(4, u // 200))
    args = _torch_args(words, lengths, gids, _queries(u, seed=r, r=r), cuda)
    before = td.neighbor_lists_fused.launches
    got = td.neighbor_lists_fused(*args, threshold, k)
    assert td.neighbor_lists_fused.launches == before + 1
    want = td.neighbor_lists_fused_plain(*args, threshold, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_kernel_rejects_wide_rows_on_card(cuda):
    words, lengths, gids = _fans(10, 3, seed=1)
    args = _torch_args(words, lengths, gids, _queries(10, seed=1), cuda)
    with pytest.raises(ValueError, match="1 or 2 lanes"):
        td.neighbor_lists_fused(*args, 1, 16)


def test_main_pass_launches_h_only_on_card(cuda):
    from shortseq_torch.ops.pairwise import hamming_pairwise_tiled

    words, _, _ = _fans(4000, 2, seed=4, bases=400)
    lengths = np.full(4000, 12)
    want = csr_rows(td._neighbor_lists(words, lengths, 1, device="cpu"))
    h, b = td.neighbor_lists_fused.launches, hamming_pairwise_tiled.launches
    got = csr_rows(td._neighbor_lists(words, lengths, 1, device=cuda))
    assert td.neighbor_lists_fused.launches == h + 1
    if max(map(len, want)) <= td._NEIGHBOR_K:
        assert hamming_pairwise_tiled.launches == b
    assert len(got) == len(want)
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w_))
