"""shortseq_torch neighbour lists (kernels B + C, plain versions on the
CPU) against the JAX package's _neighbor_lists on identical packed words:
group ids, pad rows, several block sizes, the overflow tier and the dense
tier, kernel C's edge rows (chip_smoke.c_edge_slab, which the card run
also checks).  Mirrors tests/test_umi.py:257-320,474-490.  Exact
comparisons."""

import numpy as np
import pytest
import torch

import shortseq_torch.umi.dedup as td
import shortseq_tpu.umi.dedup as jd
from chip_smoke import c_edge_slab, csr_rows

ALPHA = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _packed(umis):
    """Identical inputs for both packages: JAX-packed words as uint32."""
    words, lengths = jd._pack_validate_umis(umis)
    return np.asarray(words), lengths


def _variant_umis(u, length, seed, frac=0.5):
    """u UMIs of one length, a fraction of them one substitution away
    from an earlier one (real neighbours), first occurrences kept."""
    rng = np.random.default_rng(seed)
    mat = ALPHA[rng.integers(0, 4, size=(u, length))]
    var = rng.random(u) < frac
    src = rng.integers(0, u, size=u)
    mat[var] = mat[src[var]]
    pos = rng.integers(0, length, size=u)
    mat[var, pos[var]] = ALPHA[rng.integers(0, 4, size=u)[var]]
    return list(dict.fromkeys(mat[i].tobytes() for i in range(u)))


def _assert_lists_equal(got, want):
    """The port's CSR `got`, row by row, against the lists `want`."""
    got = csr_rows(got)
    assert len(got) == len(want)
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(np.asarray(g, np.int64),
                                      np.asarray(w, np.int64), err_msg=r)


@pytest.mark.parametrize("block", [None, 5, 64, 300])
@pytest.mark.parametrize("threshold", [1, 2])
def test_matches_jax_blocks(block, threshold):
    words, lengths = _packed(_variant_umis(257, 6, seed=threshold))
    got = td._neighbor_lists(words, lengths, threshold, block=block,
                             device="cpu")
    want = jd._neighbor_lists(words, lengths, threshold, block=block)
    _assert_lists_equal(got, want)
    assert sum(map(len, want)) > 0


@pytest.mark.parametrize("u", [127, 128, 129])
def test_matches_jax_with_gids_and_mixed_lengths(u):
    rng = np.random.default_rng(u)
    umis = _variant_umis(u, 8, seed=u)
    # Mixed lengths: some UMIs cut to 7 nt never neighbour the 8-nt ones.
    umis = [x[:7] if rng.random() < 0.2 else x for x in umis]
    words, lengths = _packed(umis)
    gids = rng.integers(0, 3, size=len(umis))
    got = td._neighbor_lists(words, lengths, 1, gids=gids, device="cpu")
    want = jd._neighbor_lists(words, lengths, 1, gids=gids)
    _assert_lists_equal(got, want)


def _clique():
    return [b"AAAA", b"AAAT", b"AAAC", b"AAAG", b"ATAA", b"ACAA", b"AGAA",
            b"TAAA"]


def test_overflow_tier_matches_jax(monkeypatch):
    words, lengths = _packed(_clique())
    full = td._neighbor_lists(words, lengths, 2, device="cpu")
    monkeypatch.setattr(td, "_NEIGHBOR_K", 2)
    monkeypatch.setattr(jd, "_NEIGHBOR_K", 2)
    got = td._neighbor_lists(words, lengths, 2, device="cpu")
    want = jd._neighbor_lists(words, lengths, 2)
    _assert_lists_equal(got, want)
    _assert_lists_equal(got, csr_rows(full))
    assert np.diff(full.indptr).max() > 2   # the cap really overflowed


def test_dense_tier_matches_jax(monkeypatch):
    words, lengths = _packed(_clique())
    full = td._neighbor_lists(words, lengths, 2, device="cpu")
    for mod in (td, jd):
        monkeypatch.setattr(mod, "_NEIGHBOR_K", 2)
        monkeypatch.setattr(mod, "_OVERFLOW_K", 3)
    got = td._neighbor_lists(words, lengths, 2, device="cpu")
    want = jd._neighbor_lists(words, lengths, 2)
    _assert_lists_equal(got, want)
    _assert_lists_equal(got, csr_rows(full))
    assert np.diff(full.indptr).max() > 3   # the dense tier really ran


@pytest.mark.parametrize("caps", [(2, 3, 3), (1, 4, 2)])
def test_overflow_batches_and_dense_tier_match_jax(monkeypatch, caps):
    # Rows over the main cap go through the overflow tier in several
    # batches (the slab budget off, so each batch is _DENSE_ROWS_BATCH
    # rows), and rows over _OVERFLOW_K through the dense tier.
    k, k2, rows = caps
    words, lengths = _packed(_variant_umis(40, 5, seed=11, frac=0.8))
    full = td._neighbor_lists(words, lengths, 2, device="cpu")
    deg = np.diff(full.indptr)
    assert (deg > k2).sum() >= 2 and ((deg > k) & (deg <= k2)).sum() >= 2
    assert (deg > k).sum() >= 3 * rows      # at least three overflow batches
    for mod in (td, jd):
        monkeypatch.setattr(mod, "_NEIGHBOR_K", k)
        monkeypatch.setattr(mod, "_OVERFLOW_K", k2)
        monkeypatch.setattr(mod, "_DENSE_ROWS_BATCH", rows)
    monkeypatch.setattr(td, "_OVERFLOW_SLAB", 0)
    slabs = []
    real = td.hamming_pairwise_tiled

    def counted(a, b, out=None):
        slabs.append(a.shape[0])
        return real(a, b, out=out)

    monkeypatch.setattr(td, "hamming_pairwise_tiled", counted)
    got = td._neighbor_lists(words, lengths, 2, device="cpu")
    want = jd._neighbor_lists(words, lengths, 2)
    _assert_lists_equal(got, want)
    _assert_lists_equal(got, csr_rows(full))
    n_over, n_dense = (deg > k).sum(), (deg > k2).sum()
    assert slabs == [rows] * (n_over // rows) + [n_over % rows] * bool(
        n_over % rows) + [rows] * (n_dense // rows) + [n_dense % rows] * bool(
        n_dense % rows)


def _fan(base, doubles=False):
    """`base` and each of its single-substitution variants, and with
    `doubles` each double-substitution one too (all distinct)."""
    out = [base]
    for i, a in enumerate(base):
        for c in ALPHA:
            if c != a:
                v = bytearray(base)
                v[i] = c
                out.append(bytes(v))
                for j in range(i + 1, len(base) if doubles else 0):
                    for c2 in ALPHA:
                        if c2 != base[j]:
                            v2 = bytearray(v)
                            v2[j] = c2
                            out.append(bytes(v2))
    return out


def _random_umis(n, length, seed):
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(ALPHA[rng.integers(0, 4, size=(n, length))][i]
                              .tobytes() for i in range(n)))


def _splice_case(name):
    """(UMIs, rows that must go over the main cap at threshold 2)."""
    rng = np.random.default_rng(len(name))
    bases = _random_umis(3, 12, seed=21)
    if name == "dense":
        # One 8-nt fan with its double substitutions (its base has 276
        # neighbours, over _OVERFLOW_K), one 12-nt fan of singles (36
        # each, between the caps) and random 10-nt UMIs, shuffled.
        umis = (_fan(_random_umis(1, 8, seed=20)[0], doubles=True)
                + _fan(bases[0]) + _random_umis(60, 10, seed=22))
        return [umis[i] for i in rng.permutation(len(umis))], None
    if name == "ends":
        # Fans of 12-nt singles first and last: rows 0 and U-1 over 16.
        tail = _fan(bases[2])
        umis = _fan(bases[1]) + _random_umis(50, 12, seed=23) + tail[::-1]
        return umis, [0, len(umis) - 1]
    return _random_umis(40, 16, seed=24), None      # no edges at all


@pytest.mark.parametrize("name", ["dense", "ends", "no_edges"])
def test_overflow_splice_matches_jax(name):
    """At the real caps, rows over _NEIGHBOR_K (and over _OVERFLOW_K,
    the dense mask) are spliced into the CSR in place of their main-pass
    slots, each row held to the JAX package's list."""
    umis, over_at = _splice_case(name)
    words, lengths = _packed(umis)
    before = (td._neighbor_lists.edges, td._neighbor_lists.overflow_rows)
    nbrs = td._neighbor_lists(words, lengths, 2, device="cpu")
    want = jd._neighbor_lists(words, lengths, 2)
    _assert_lists_equal(nbrs, want)
    deg = np.diff(nbrs.indptr)
    assert td._neighbor_lists.edges - before[0] == len(nbrs.indices)
    assert td._neighbor_lists.overflow_rows - before[1] == \
        (deg > td._NEIGHBOR_K).sum()
    if name == "dense":
        assert (deg > td._OVERFLOW_K).any() and (deg <= td._NEIGHBOR_K).any()
        assert ((deg > td._NEIGHBOR_K) & (deg <= td._OVERFLOW_K)).any()
    elif name == "ends":
        assert (deg[over_at] > td._NEIGHBOR_K).all()
        assert (deg <= td._NEIGHBOR_K).any()
    else:
        assert len(nbrs.indices) == 0 and not nbrs.indptr.any()


def test_extract_writes_into_out():
    t = [torch.from_numpy(x) for x in _slab(12, 300, seed=5)]
    want = td.neighbor_extract(*t, 1, 8)
    idx = torch.full((20, 8), -7, dtype=torch.int32)
    cnt = torch.full((20,), -7, dtype=torch.int32)
    got = td.neighbor_extract(*t, 1, 8, out=(idx[4:16], cnt[4:16]))
    assert got[0].data_ptr() == idx[4:16].data_ptr()
    assert torch.equal(idx[4:16], want[0]) and torch.equal(cnt[4:16], want[1])
    assert (idx[:4] == -7).all() and (cnt[16:] == -7).all()
    with pytest.raises(ValueError, match="out idx"):
        td.neighbor_extract(*t, 1, 8, out=(idx[:12, :4], cnt[:12]))


@pytest.mark.parametrize("u", [1001, 1004, 7424])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_extract_plain_edge_rows_match_jax(u, k):
    import jax.numpy as jnp

    dist, a_len, a_gid, a_rows, lengths, gids = c_edge_slab(u, k, seed=u + k)
    t = [torch.from_numpy(x) for x in (dist, a_len, a_gid, a_rows, lengths,
                                       gids)]
    idx, cnt = td.neighbor_extract(*t, 1, k)
    cols = np.arange(u)
    adj = ((dist <= 1) & (a_len[:, None] == lengths[None, :])
           & (a_gid[:, None] == gids[None, :])
           & (cols[None, :] != a_rows[:, None]))
    score = np.where(adj, u - cols, 0).astype(np.int32)
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(jd._extract_ascending(jnp.asarray(score), k)))
    np.testing.assert_array_equal(cnt.numpy(), adj.sum(axis=1))
    assert list(cnt.numpy()[:4]) == [0, k, k + 5, 2]


def _slab(b, u, seed):
    """Random distance slab with pad columns (length -1), two groups and
    the rows' own columns, so every mask term matters."""
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 4, size=(b, u)).astype(np.int32)
    lengths = np.where(rng.random(u) < 0.1, -1, 12).astype(np.int32)
    gids = rng.integers(0, 2, size=u).astype(np.int32)
    a_rows = rng.choice(u, size=b, replace=False).astype(np.int32)
    return dist, lengths[a_rows], gids[a_rows], a_rows, lengths, gids


@pytest.mark.parametrize("k", [1, 4, 16])
def test_extract_plain_matches_jax_extraction(k):
    import jax.numpy as jnp

    dist, a_len, a_gid, a_rows, lengths, gids = _slab(40, 256, seed=k)
    t = [torch.from_numpy(x) for x in (dist, a_len, a_gid, a_rows, lengths,
                                       gids)]
    idx, cnt = td.neighbor_extract(*t, 1, k)
    # The JAX score encoding: U - col on neighbours, 0 elsewhere.
    u = dist.shape[1]
    cols = np.arange(u)
    adj = ((dist <= 1) & (a_len[:, None] == lengths[None, :])
           & (a_gid[:, None] == gids[None, :])
           & (cols[None, :] != a_rows[:, None]))
    score = np.where(adj, u - cols, 0).astype(np.int32)
    want_idx = np.asarray(jd._extract_ascending(jnp.asarray(score), k))
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_array_equal(cnt.numpy(), adj.sum(axis=1))
    assert (cnt.numpy() > k).any()


@pytest.mark.parametrize("k", [1, 16, 128])
def test_extract_kernel_matches_plain_on_card(cuda, k):
    host = _slab(300, 5000, seed=k)
    t = [torch.from_numpy(x).to(cuda) for x in host]
    before = td.neighbor_extract.launches
    got = td.neighbor_extract(*t, 1, k)
    assert td.neighbor_extract.launches == before + 1
    want = td.neighbor_extract_plain(*t, 1, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("u", [1001, 1003, 1004, 7424])
@pytest.mark.parametrize("k", [1, 16, 128])
@pytest.mark.parametrize("segs", [0, 1, 3, 8, 16])
def test_extract_kernel_edge_rows_on_card(cuda, monkeypatch, u, k, segs):
    monkeypatch.setattr(td, "_EXTRACT_SEGS", segs)
    host = c_edge_slab(u, k, seed=u + k)
    t = [torch.from_numpy(x).to(cuda) for x in host]
    want = td.neighbor_extract_plain(*t, 1, k)
    got = td.neighbor_extract(*t, 1, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # The same slab one element off 16-byte alignment.
    off = torch.empty(host[0].size + 1, dtype=torch.int32, device=cuda)
    dist = off[1:].view(host[0].shape)
    dist.copy_(t[0])
    got = td.neighbor_extract(dist, *t[1:], 1, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_neighbor_lists_card_matches_cpu(cuda, monkeypatch):
    words, lengths = _packed(_variant_umis(3000, 10, seed=3))
    want = csr_rows(td._neighbor_lists(words, lengths, 2, device="cpu"))
    got = td._neighbor_lists(words, lengths, 2, device=cuda)
    _assert_lists_equal(got, want)
    monkeypatch.setattr(td, "_NEIGHBOR_K", 2)
    monkeypatch.setattr(td, "_OVERFLOW_K", 3)
    got = td._neighbor_lists(words, lengths, 2, device=cuda)
    _assert_lists_equal(got, want)
