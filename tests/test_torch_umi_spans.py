"""The UMI path's host ranges and counters: one dedup_fastq call is one
tree of ssq.umi_* ranges under ssq.umi_dedup (utils/profiling.py lists
them), each stage inside the root and no range inside another of its own
name; `_neighbor_lists` counts its rows, pairs, in-group pairs, overflow
rows, edges and UMI lanes as worked out by hand for a small library, on
the CPU, for the ragged path (the CLI's, reads of several lengths) and
the matrix path (reads of one length), and the ragged path's count of
the reads it took as a padded matrix or as a list."""

import collections

import pytest
from torch.profiler import ProfilerActivity, profile

import shortseq_torch as st
from shortseq_torch.umi import dedup

Range = collections.namedtuple("Range", "name start end")

ROOT = "ACGTACGTACGT"


def _variants(umi):
    for i, base in enumerate(umi):
        for other in "ACGT":
            if other != base:
                yield umi[:i] + other + umi[i + 1:]


def _reads(ragged):
    """Insert A: a UMI of 50 reads and its 36 one-base variants of 1 read
    (so its row has 36 neighbours, over k = 16); insert B: two UMIs one
    base apart, of 3 reads and 1; insert C: one read."""
    a, b, c = ("ACGTTGCAACGTTGCAACGT", "GGGGCCCCAAAATTTTGGCA",
               "TTGCATGCATGCATGCATGC")
    if ragged:
        b, c = b + "AC", c[:18]
    return ([a + ROOT] * 50 + [a + v for v in _variants(ROOT)]
            + [b + "CCCCAAAAGGGG"] * 3 + [b + "CCCCAAAAGGGT"]
            + [c + "TTTTGGGGCCCC"])


#: By hand: 37 + 2 candidate rows (C's lone key is none); kernel H's
#: columns padded to 256; 37 * 36 + 2 * 1 ordered pairs inside an insert;
#: the root's 36 neighbours, 3 for each variant (the root and the two
#: others at its position), 1 each in B; one 32-bit lane a 12-nt UMI.
COUNTS = {"rows": 39, "pairs": 39 * 256, "group_pairs": 37 * 36 + 2,
          "overflow_rows": 1, "edges": 36 + 36 * 3 + 2, "umi_lanes": 39}

#: The ragged path's counters of the reads it took, by input form.
RAGGED = ("padded_reads", "list_reads")

#: name: (ranges in one call, parent).
SPANS = {
    "ssq.umi_dedup": (1, None),
    "ssq.umi_read": (1, "ssq.umi_dedup"),
    "ssq.umi_group": (1, "ssq.umi_dedup"),
    "ssq.umi_pack": (1, "ssq.umi_dedup"),
    "ssq.umi_neighbors": (1, "ssq.umi_dedup"),
    # the walk, the relabel and molecule tuples, the reads per molecule
    "ssq.umi_collapse": (3, "ssq.umi_dedup"),
}


@pytest.fixture(scope="module", params=[True, False],
                ids=["ragged", "matrix"])
def traced(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("umi_spans") / "reads.fastq"
    reads = _reads(request.param)
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    before = {a: getattr(dedup._neighbor_lists, a) for a in COUNTS}
    before.update({a: getattr(dedup._dedup_reads_ragged, a)
                   for a in RAGGED})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        molecules, per = st.dedup_fastq(str(path), len_3p=12, device="cpu")
    grown = {a: getattr(dedup._neighbor_lists, a) - before[a]
             for a in COUNTS}
    grown.update({a: getattr(dedup._dedup_reads_ragged, a) - before[a]
                  for a in RAGGED})
    grown["ragged"] = request.param
    assert len(molecules) == 3 and sorted(per.tolist()) == [1, 4, 86]
    ranges = sorted((Range(e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events() if e.name.startswith("ssq.")),
                    key=lambda r: (r.start, -r.end))
    return ranges, grown


def _inside(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end \
        and inner is not outer


@pytest.mark.parametrize("name", sorted(SPANS))
def test_umi_span_count_and_parent(traced, name):
    ranges, _ = traced
    count, parent = SPANS[name]
    mine = [r for r in ranges if r.name == name]
    assert len(mine) == count
    for r in mine:
        umi_parents = [o for o in ranges if _inside(r, o)
                       and o.name.startswith("ssq.umi_")]
        if parent is None:
            assert not umi_parents
        else:
            inner = min(umi_parents, key=lambda o: o.end - o.start)
            assert inner.name == parent


def test_no_range_inside_its_own_name(traced):
    ranges, _ = traced
    for r in ranges:
        assert not any(_inside(r, o) and o.name == r.name for o in ranges), r


def test_umi_stages_only_inside_the_root(traced):
    ranges, _ = traced
    roots = [r for r in ranges if r.name == "ssq.umi_dedup"]
    for r in ranges:
        if r.name != "ssq.umi_dedup":
            assert any(_inside(r, o) for o in roots), r


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_neighbor_counters(traced, name):
    _, grown = traced
    assert grown[name] == COUNTS[name]


def test_ragged_path_counts_the_padded_matrix(traced):
    """Every file, ragged or of one read length, reaches
    _dedup_reads_ragged as read_fastq_matrix's padded matrix."""
    _, grown = traced
    assert grown["padded_reads"] == len(_reads(grown["ragged"]))
    assert grown["list_reads"] == 0


def test_ragged_path_counts_a_list():
    reads = _reads(True)
    before = {a: getattr(dedup._dedup_reads_ragged, a) for a in RAGGED}
    labels, molecules = st.dedup_reads(reads, len_3p=12, device="cpu")
    assert len(molecules) == 3 and len(labels) == len(reads)
    grown = {a: getattr(dedup._dedup_reads_ragged, a) - before[a]
             for a in RAGGED}
    assert grown == {"padded_reads": 0, "list_reads": len(reads)}
