"""shortseq_torch's UMI objects and umi_adjacency against shortseq_tpu.umi
on the cases of tests/test_umi.py (reference tests/unit_tests_umi.py:6-29):
the same classes, fields, strings, equality and errors, and the same
adjacency matrices (exact).  The pairwise selector calibrates into a
temporary directory; the JAX side is pinned to its broadcast path."""

import itertools

import numpy as np
import pytest
import torch

import shortseq_torch as st
import shortseq_torch.umi as tu
import shortseq_tpu.umi as ju
from shortseq_torch.ops import pairwise as tp
from shortseq_torch.ops.lanes import to_numpy_u32


@pytest.fixture(autouse=True)
def _pairwise_env(tmp_path, monkeypatch):
    monkeypatch.setattr(tp, "_calib_file",
                        lambda: str(tmp_path / "calib.json"))
    monkeypatch.setattr(tp, "_CALIBRATION", {})
    monkeypatch.delenv("SHORTSEQ_TORCH_PAIRWISE", raising=False)
    monkeypatch.setenv("SHORTSEQ_TPU_PAIRWISE", "jnp")


def fields(u):
    """(class name, str of each field) of a UMI object."""
    return (type(u).__name__,) + tuple(
        str(getattr(u, f)) for f in ("seq", "umi5", "umi3") if hasattr(u, f))


def test_exports():
    for name in ("UMI", "UMI5p", "UMI3p", "UMIboth", "UMIFactory",
                 "umi_adjacency", "PackedBatch", "pack_batch"):
        assert name in st.__all__ and getattr(st, name) is not None
    assert st.UMIFactory is tu.UMIFactory


def test_construct():
    for cls in ("UMI", "UMI5p", "UMI3p", "UMIboth"):
        t, j = getattr(tu, cls)(), getattr(ju, cls)()
        assert fields(t) == fields(j)
        assert len(t) == len(j) == 0
        assert repr(t) == repr(j)


@pytest.mark.parametrize("len_5p,len_3p,cls", [(1, 0, "UMI5p"),
                                                (0, 1, "UMI3p"),
                                                (1, 1, "UMIboth"),
                                                (0, 0, "UMI")])
def test_factory_construct(len_5p, len_3p, cls):
    t = tu.UMIFactory(len_5p=len_5p, len_3p=len_3p).from_bytes(b"ATGC")
    j = ju.UMIFactory(len_5p=len_5p, len_3p=len_3p).from_bytes(b"ATGC")
    assert isinstance(t, getattr(tu, cls))
    assert fields(t) == fields(j)
    assert repr(t) == repr(j)


def test_seq_basic_and_split_contents():
    seq = b"GCGTAATAGGGGGTTTCGCTGTGGGGCGGCTAG"
    assert (fields(tu.UMIFactory(len_5p=5).from_bytes(seq))
            == fields(ju.UMIFactory(len_5p=5).from_bytes(seq)))
    u = tu.UMIFactory(len_5p=3, len_3p=2).from_bytes(b"AAACGTACGTTT")
    assert (str(u.umi5), str(u.umi3), str(u.seq)) == ("AAA", "TT", "CGTACGT")
    assert fields(u) == fields(
        ju.UMIFactory(len_5p=3, len_3p=2).from_bytes(b"AAACGTACGTTT"))
    assert (fields(tu.UMIFactory(len_3p=2).from_str("ACGTTA"))
            == fields(ju.UMIFactory(len_3p=2).from_str("ACGTTA")))
    reads = [b"AACGT", b"TTTTT", b"ACGTACGTAC"]
    assert ([fields(u) for u in tu.UMIFactory(1, 2).from_iter(reads)]
            == [fields(u) for u in ju.UMIFactory(1, 2).from_iter(reads)])


def test_eq_and_hash():
    f = tu.UMIFactory(len_5p=2)
    a, b = f.from_bytes(b"AACGT"), f.from_bytes(b"AACGT")
    c = f.from_bytes(b"ATCGT")
    assert a == b and hash(a) == hash(b)
    assert a != c
    assert a != tu.UMIFactory(len_3p=2).from_bytes(b"AACGT")
    assert tu.UMIboth(st.pack("AC")) != tu.UMIboth(st.pack("AC"),
                                                   st.pack("A"))


@pytest.mark.parametrize("pkg", [tu, ju], ids=["torch", "jax"])
def test_errors(pkg):
    with pytest.raises(ValueError, match="shorter than"):
        pkg.UMIFactory(len_5p=3, len_3p=3).from_bytes(b"ACGT")
    with pytest.raises(ValueError, match="non-negative"):
        pkg.UMIFactory(len_5p=-1)
    with pytest.raises(ValueError, match="above 32"):
        pkg.UMIFactory(len_3p=33)
    with pytest.raises(Exception, match="Unsupported base character"):
        pkg.UMIFactory(len_5p=2).from_bytes(b"ACNT")


def _packed(umis, width=32):
    """[U, 32] uint8 UMI matrix -> (JAX words, port words on the CPU,
    lengths)."""
    import jax.numpy as jnp

    from shortseq_torch.ops.bitpack import pack_words
    from shortseq_tpu.ops.bitpack import pack_words as jax_pack_words

    mat = np.zeros((len(umis), width), np.uint8)
    for i, u in enumerate(umis):
        mat[i, :len(u)] = np.frombuffer(u, np.uint8)
    lengths = np.array([len(u) for u in umis], np.int32)
    jw = jax_pack_words(jnp.asarray(mat))
    tw = pack_words(torch.from_numpy(mat))
    np.testing.assert_array_equal(to_numpy_u32(tw), np.asarray(jw))
    return jw, tw, lengths


def test_umi_adjacency_matches_strings_and_jax():
    umis = [b"ACGT", b"ACGA", b"TCGA", b"ACGT", b"AAAA"]
    uniq = sorted(set(umis))
    jw, tw, lengths = _packed(uniq)
    adj = tu.umi_adjacency(tw, lengths, threshold=1)
    assert adj.dtype == bool and adj.shape == (len(uniq), len(uniq))
    np.testing.assert_array_equal(adj, ju.umi_adjacency(jw, lengths, 1))
    for i, j in itertools.product(range(len(uniq)), repeat=2):
        dist = sum(a != b for a, b in zip(uniq[i], uniq[j]))
        assert adj[i, j] == (dist <= 1), (uniq[i], uniq[j])


@pytest.mark.parametrize("threshold", [0, 1, 2])
def test_umi_adjacency_mixed_lengths_matches_jax(threshold):
    rng = np.random.default_rng(threshold)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    umis = [alpha[rng.integers(0, 4, size=int(n))].tobytes()
            for n in rng.integers(6, 10, size=60)]
    umis += [u[:-1] + b"A" for u in umis[:20]]
    jw, tw, lengths = _packed(umis)
    got = tu.umi_adjacency(tw, lengths, threshold)
    np.testing.assert_array_equal(got, ju.umi_adjacency(jw, lengths,
                                                        threshold))
    # numpy words go to the CPU and give the same matrix.
    np.testing.assert_array_equal(
        tu.umi_adjacency(to_numpy_u32(tw), lengths, threshold), got)


def test_umi_adjacency_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    umis = [alpha[rng.integers(0, 4, size=12)].tobytes() for _ in range(700)]
    umis += [u[:5] + b"T" + u[6:] for u in umis[:300]]
    _, tw, lengths = _packed(umis)
    np.testing.assert_array_equal(
        tu.umi_adjacency(tw.cuda(), lengths, 1),
        tu.umi_adjacency(tw, lengths, 1))
