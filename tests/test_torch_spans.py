"""The count path's host ranges: one library call is one tree of ssq.*
ranges under ssq.read_count (utils/profiling.py lists them), each range
as often as the path takes its stage and inside its parent, and no range
inside another of its own name.  A FASTQ of two width buckets goes
through the whole-file path and the streamed path (three byte-range
slices) on the CPU, then the streamed table's lazy reads and its dict.
The transfer counters count only copies that cross to or from a CUDA
device: on the CPU they stay; on the card the counter cell's exact bytes
(10 a read in, 16 a unique row out) are checked."""

import collections
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import shortseq_torch as st
from shortseq_torch.count import device as cdev

READS = 600
BUCKETS = 2   # reads of 20 nt (2 lanes) and 50 nt (6 lanes), alternating
SLICES = 3

Range = collections.namedtuple("Range", "name start end")


def _write_fastq(path, reads=READS, seed=0):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(reads):
            n = 20 if i % 2 else 50
            seq = "".join("ACGT"[x] for x in rng.integers(0, 4, n))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")


def _counters():
    return (cdev.h2d.bytes, cdev.h2d.copies, cdev.d2h.bytes,
            cdev.d2h.copies)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The ssq.* ranges of a whole-file call, a streamed call and the
    streamed table's most_common, total and to_counter, with the
    transfer counters before and after."""
    path = tmp_path_factory.mktemp("spans") / "reads.fastq"
    _write_fastq(path)
    before = _counters()
    old = os.environ.get("SHORTSEQ_TORCH_STREAM_BYTES")
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            whole = st.read_and_count_fastq_table(str(path),
                                                  engine="device",
                                                  device="cpu")
            os.environ["SHORTSEQ_TORCH_STREAM_BYTES"] = str(
                os.path.getsize(path) // SLICES + 1)
            streamed = st.read_and_count_fastq_table(str(path),
                                                     engine="device",
                                                     device="cpu")
            top = streamed.most_common(5)
            total = streamed.total()
            counter = streamed.to_counter()
    finally:
        if old is None:
            os.environ.pop("SHORTSEQ_TORCH_STREAM_BYTES", None)
        else:
            os.environ["SHORTSEQ_TORCH_STREAM_BYTES"] = old
    assert len(whole) == len(counter) == READS and total == READS
    assert len(top) == 5
    ranges = sorted((Range(e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events() if e.name.startswith("ssq.")),
                    key=lambda r: (r.start, -r.end))
    return ranges, before, _counters()


def _inside(inner, outer):
    return outer.start <= inner.start and inner.end <= outer.end \
        and inner is not outer


def _parents(r, ranges):
    return [o for o in ranges if _inside(r, o)]


def _innermost_parent(r, ranges):
    ps = _parents(r, ranges)
    return min(ps, key=lambda o: o.end - o.start) if ps else None


B, S = BUCKETS, SLICES
# name: (count in the whole-file call, in the streamed call, after both
# calls, the parent's name: None for a root, "ssq." for any ssq range).
SPANS = {
    "ssq.read_count": (1, 1, 0, None),
    "ssq.file_read": (1, S, 0, "ssq.read_count"),
    "ssq.index": (1, S, 0, "ssq.read_count"),
    "ssq.gather_pack": (B, B * S, 0, "ssq.read_count"),
    # words and lengths a bucket a slice; the merge's three arrays a width
    "ssq.h2d": (2 * B, 2 * B * S + 3 * B, 0, "ssq."),
    "ssq.unique_count": (B, B * S + B, 0, "ssq."),
    # len(): n_unique a bucket; a slice's fetch: n_unique and 3 arrays a
    # bucket; most_common: its minimum and 3 arrays a bucket; total(): one
    # a bucket; to_counter(): 3 arrays a bucket (n_unique already read)
    "ssq.d2h": (B, 4 * B * S + B, 4 * B + B + 3 * B, "ssq."),
    "ssq.merge": (0, B, 0, "ssq.read_count"),
    "ssq.to_counter": (0, 0, 1, None),
    "ssq.objects": (0, 0, B, "ssq.to_counter"),
    "ssq.table_read": (0, 0, 2, None),
}


@pytest.mark.parametrize("name", sorted(SPANS))
def test_span_count_and_parent(traced, name):
    ranges, _, _ = traced
    roots = [r for r in ranges if r.name == "ssq.read_count"]
    assert len(roots) == 2
    whole, streamed, after, parent = SPANS[name]
    mine = [r for r in ranges if r.name == name]
    in_whole = [r for r in mine if r is roots[0] or _inside(r, roots[0])]
    in_streamed = [r for r in mine
                   if r is roots[1] or _inside(r, roots[1])]
    assert (len(in_whole), len(in_streamed),
            len(mine) - len(in_whole) - len(in_streamed)) == \
        (whole, streamed, after)
    for r in mine:
        # No range holds another of its own name.
        assert not [o for o in _parents(r, ranges) if o.name == name]
        up = _innermost_parent(r, ranges)
        if parent is None:
            assert up is None, f"{name} inside {up}"
        elif parent == "ssq.":
            assert up is not None
        else:
            assert parent in {o.name for o in _parents(r, ranges)}
    if name in ("ssq.file_read", "ssq.index", "ssq.gather_pack",
                "ssq.merge"):
        # Directly under the call's root: no other range between.
        assert all(_innermost_parent(r, ranges).name == "ssq.read_count"
                   for r in mine)


def test_no_copy_crosses_on_the_cpu(traced):
    _, before, after = traced
    assert after == before


def test_read_seconds_bracket_the_read_and_index(tmp_path):
    """_read_seconds is the interval of read_fastq_index: it holds the
    ssq.file_read and ssq.index ranges and little else."""
    path = tmp_path / "reads.fastq"
    _write_fastq(path, reads=2000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        table = st.read_and_count_fastq_table(str(path), engine="device",
                                              device="cpu")
    spent = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.name in ("ssq.file_read", "ssq.index")) / 1e6
    assert 0 < spent <= table._read_seconds < spent + 0.05


def test_eager_call_holds_its_dict(tmp_path):
    """read_and_count_fastq builds its dict inside the call's root."""
    path = tmp_path / "reads.fastq"
    _write_fastq(path, reads=40)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        st.read_and_count_fastq(str(path), engine="device", device="cpu")
    ranges = [Range(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("ssq.")]
    root, = [r for r in ranges if r.name == "ssq.read_count"]
    to_counter, = [r for r in ranges if r.name == "ssq.to_counter"]
    assert _inside(to_counter, root)


def test_hash_path_reads_its_collision_word_through_d2h():
    """unique_count over 6 lanes reads each hash family's collision word
    on the host: one ssq.d2h inside ssq.unique_count."""
    rng = np.random.default_rng(1)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (64, 8),
                                          dtype=np.int64).astype(np.int32))
    lengths = torch.full((64,), 128, dtype=torch.int32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cdev.unique_count(words, lengths, torch.ones(64, dtype=torch.int32))
    ranges = [Range(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("ssq.")]
    reads = [r for r in ranges if r.name == "ssq.d2h"]
    root, = [r for r in ranges if r.name == "ssq.unique_count"]
    assert len(reads) == 1 and _inside(reads[0], root)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def test_counter_cell_bytes_on_the_card(cuda, tmp_path):
    """One bucket of 2-lane reads: 8 bytes of lanes and 2 of int16 length
    a read go over, two copies a chunk; len() reads n_unique (4 bytes),
    and to_counter() fetches 16 bytes a unique row in three copies."""
    path = tmp_path / "reads.fastq"
    rng = np.random.default_rng(2)
    reads = 5000
    with open(path, "w") as f:
        for i in range(reads):
            n = int(rng.integers(15, 33))
            seq = "".join("ACGT"[x] for x in rng.integers(0, 4, n))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * n}\n")
    h0 = (cdev.h2d.bytes, cdev.h2d.copies)
    d0 = (cdev.d2h.bytes, cdev.d2h.copies)
    table = st.read_and_count_fastq_table(str(path), engine="device",
                                          device=cuda)
    unique = len(table)
    counter = table.to_counter()
    assert len(counter) == unique
    assert (cdev.h2d.bytes - h0[0], cdev.h2d.copies - h0[1]) == \
        (10 * reads, 2)
    assert (cdev.d2h.bytes - d0[0], cdev.d2h.copies - d0[1]) == \
        (16 * unique + 4, 4)
