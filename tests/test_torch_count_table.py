"""shortseq_torch's CountTable against shortseq_tpu's on the same FASTQ,
for the host and the device engine (the port's device engine on
device="cpu": the plain versions of kernels S, I and D).
Mirrors tests/test_count_table.py.

Two files: "narrow" holds reads of at most 96 nt (width buckets of 2 and
6 lanes, sorted by key in both packages); "mixed" adds 97-300 nt reads,
whose 64-lane bucket both packages order by the row hash.  On both, the
tables are identical, so most_common(n) agrees down to the members of a
tie at the boundary count, and to_counter() in its insertion order."""

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
        if name == "mixed":
            # 60 more 97-300 nt reads, 1 to 3 times each: ties at small
            # counts inside the 64-lane bucket, whose order is the hash's.
            extra = np.random.default_rng(0xF00D)
            reads += [r for r in _pool(extra, 60, 97, 300)
                      for _ in range(int(extra.integers(1, 4)))]
        out[name] = (_write_fastq(d / f"{name}.fastq", reads), reads)
    return out


@pytest.fixture(params=[(f, e) for f in ("narrow", "mixed") for e in ENGINES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def tables(request, files):
    name, engine = request.param
    path, reads = files[name]
    got = st.read_and_count_fastq_table(path, engine=engine, device="cpu")
    want = sq.read_and_count_fastq_table(path, engine=engine)
    return got, want, collections.Counter(reads)


def _pairs(items):
    return [(str(k), c) for k, c in items]


def test_len_and_total(tables):
    got, want, expect = tables
    assert len(got) == len(want) == len(expect)
    assert got.total() == want.total() == sum(expect.values())


def test_most_common_top_n(tables):
    got, want, expect = tables
    counts = list(expect.values())
    # Besides fixed n, each n that cuts a tie (one slot for keys that
    # share a count).
    cut = [sum(v > c for v in counts) + 1 for c in sorted(set(counts))
           if counts.count(c) > 1]
    wide_ties = False
    for n in (1, 3, 5, 20, *cut):
        g, w = _pairs(got.most_common(n)), _pairs(want.most_common(n))
        assert g == w  # same tie members, same order
        for k, c in g:
            assert expect[k] == c
        if n in cut:
            wide_ties |= any(len(k) > 96 for k, v in expect.items()
                             if v == w[-1][1])
    assert cut
    # On "mixed", a tie that is cut holds a read of the 64-lane bucket.
    assert wide_ties or max(map(len, expect)) <= 96


def test_most_common_full(tables):
    got, want, expect = tables
    assert _pairs(got.most_common()) == _pairs(want.most_common())
    assert dict(_pairs(got.most_common())) == dict(expect)


def test_lookups(tables):
    got, want, expect = tables
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
    got, want, expect = tables
    assert sorted(got.values().tolist()) == sorted(want.values().tolist()) \
        == sorted(expect.values())
    assert got.values().dtype == np.int64


def test_to_counter(tables):
    got, want, expect = tables
    g, w = got.to_counter(), want.to_counter()
    assert isinstance(g, st.ShortSeqCounter)
    assert {str(k): v for k, v in g.items()} == dict(expect)
    # Same insertion order, so the CLI's stable sort by count prints the
    # same lines.
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
