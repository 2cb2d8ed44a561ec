"""shortseq_torch's CountTable against shortseq_tpu's on the same FASTQ,
for the host and the device engine (the port's device engine on
device="cpu": torch.sort + kernel D's plain version).  Mirrors
tests/test_count_table.py.

Two files: "narrow" holds reads of at most 96 nt (width buckets of 2 and
6 lanes), where both device engines build identical tables, so even the
members of a tie at the most_common(n) boundary must agree; "mixed" adds
97-300 nt reads, whose JAX bucket is in hash order, so there the entries
above the boundary count must agree."""

import collections

import numpy as np
import pytest
import torch

import shortseq_torch as st
import shortseq_tpu as sq
from shortseq_torch.count.device import PAD_LENGTH
from shortseq_torch.count.table import CountTable, _Bucket, _topk_rows

ALPHA = np.frombuffer(b"ACGT", np.uint8)
ENGINES = ("host", "device")


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


def _pool(rng, n, lo, hi):
    return [ALPHA[rng.integers(0, 4, size=int(k))].tobytes().decode()
            for k in rng.integers(lo, hi + 1, size=n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    rng = np.random.default_rng(0xBEEF)
    narrow = _pool(rng, 40, 1, 32) + _pool(rng, 12, 33, 96) + [""]
    wide = narrow + _pool(rng, 8, 97, 300)
    out = {}
    d = tmp_path_factory.mktemp("ct")
    for name, pool in (("narrow", narrow), ("mixed", wide)):
        # Skewed picks: many ties at small counts, a few large counts.
        pick = np.minimum(rng.zipf(1.6, size=700) - 1, len(pool) - 1)
        reads = [pool[i] for i in pick]
        out[name] = (_write_fastq(d / f"{name}.fastq", reads), reads)
    return out


@pytest.fixture(params=[(f, e) for f in ("narrow", "mixed") for e in ENGINES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def tables(request, files):
    name, engine = request.param
    path, reads = files[name]
    got = st.read_and_count_fastq_table(path, engine=engine, device="cpu")
    want = sq.read_and_count_fastq_table(path, engine=engine)
    return got, want, collections.Counter(reads), name == "narrow"


def _pairs(items):
    return [(str(k), c) for k, c in items]


def test_len_and_total(tables):
    got, want, expect, _ = tables
    assert len(got) == len(want) == len(expect)
    assert got.total() == want.total() == sum(expect.values())


def test_most_common_top_n(tables):
    got, want, expect, narrow = tables
    for n in (1, 3, 5, 20):
        g, w = _pairs(got.most_common(n)), _pairs(want.most_common(n))
        assert [c for _, c in g] == [c for _, c in w]
        if narrow:
            assert g == w  # same tie members, same order
        else:
            edge = w[-1][1]
            assert [kv for kv in g if kv[1] > edge] == \
                [kv for kv in w if kv[1] > edge]
        for k, c in g:
            assert expect[k] == c


def test_most_common_full(tables):
    got, want, expect, _ = tables
    assert _pairs(got.most_common()) == _pairs(want.most_common())
    assert dict(_pairs(got.most_common())) == dict(expect)


def test_lookups(tables):
    got, want, expect, _ = tables
    for seq in list(expect)[:25]:
        assert seq in got
        assert got[seq] == want[seq] == expect[seq]
        assert got[seq.encode()] == expect[seq]
        assert got[st.pack(seq)] == expect[seq]
        assert got.get(seq) == expect[seq]
    absent = "ACGTACGTTGCA"
    while absent in expect:
        absent += "A"
    assert absent not in got and got.get(absent) == 0
    with pytest.raises(KeyError):
        got[absent]
    for key in (123, "NNNN"):
        assert got.get(key) == want.get(key) == 0
        assert key not in got


def test_values(tables):
    got, want, expect, _ = tables
    assert sorted(got.values().tolist()) == sorted(want.values().tolist()) \
        == sorted(expect.values())
    assert got.values().dtype == np.int64


def test_to_counter(tables):
    got, want, expect, narrow = tables
    g, w = got.to_counter(), want.to_counter()
    assert isinstance(g, st.ShortSeqCounter)
    assert {str(k): v for k, v in g.items()} == dict(expect)
    if narrow:
        # Same insertion order, so the CLI's stable sort by count prints
        # the same lines.
        assert _pairs(g.items()) == _pairs(w.items())


def _poisoned(kind):
    if kind == "device":
        words = torch.arange(8, dtype=torch.int32).reshape(4, 2)
        lengths = torch.tensor([8, 8, 8, PAD_LENGTH], dtype=torch.int32)
        counts = torch.tensor([5, -1, 2, 0], dtype=torch.int32)
        return CountTable([_Bucket(words, lengths, counts,
                                   torch.tensor(3, dtype=torch.int32),
                                   device=True)])
    words = np.arange(6, dtype=np.uint32).reshape(3, 2)
    return CountTable.from_host_tables(
        [(words, np.full(3, 8, np.int32), np.array([5, -1, 2], np.int64))])


@pytest.mark.parametrize("kind", ["device", "host"])
@pytest.mark.parametrize("read", ["most_common_n", "most_common", "total",
                                  "to_counter", "values"])
def test_poisoned_counts_raise(kind, read):
    table = _poisoned(kind)
    call = {"most_common_n": lambda: table.most_common(2),
            "most_common": table.most_common, "total": table.total,
            "to_counter": table.to_counter, "values": table.values}[read]
    with pytest.raises(OverflowError, match="int32"):
        call()


def test_total_past_int32_raises():
    counts = torch.tensor([2**31 - 1, 1], dtype=torch.int32)
    table = CountTable([_Bucket(torch.zeros((2, 2), dtype=torch.int32),
                                torch.tensor([4, 5], dtype=torch.int32),
                                counts, 2, device=True)])
    with pytest.raises(OverflowError, match="total"):
        table.total()


@pytest.mark.parametrize("engine", ENGINES)
def test_empty_reads_as_keys(tmp_path, engine):
    reads = ["", "ACGT", "", "A", "ACGT"]
    path = _write_fastq(tmp_path / "e.fastq", reads)
    t = st.read_and_count_fastq_table(path, engine=engine, device="cpu")
    assert len(t) == 3 and t.total() == 5
    assert t[""] == 2 and t["A"] == 1 and t["ACGT"] == 2
    assert dict(_pairs(t.most_common())) == dict(collections.Counter(reads))


def test_empty_table():
    t = CountTable([])
    assert len(t) == 0 and t.total() == 0
    assert t.most_common(5) == [] and t.most_common() == []
    assert "ACGT" not in t
    assert t.to_counter() == {}


@pytest.mark.parametrize("seed", range(4))
def test_topk_rows_tie_order_matches_lax_top_k(seed):
    import jax

    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 4, size=300).astype(np.int32)
    words = rng.integers(0, 2**31, size=(300, 2)).astype(np.int32)
    lengths = np.arange(300, dtype=np.int32)
    for k in (1, 7, 64, 300):
        _, idx = jax.lax.top_k(counts, k)
        w, l, c, low = _topk_rows(torch.from_numpy(words),
                                  torch.from_numpy(lengths),
                                  torch.from_numpy(counts), k)
        np.testing.assert_array_equal(l.numpy(), np.asarray(idx))
        np.testing.assert_array_equal(c.numpy(), counts[np.asarray(idx)])
        assert int(low) == int(counts.min())
