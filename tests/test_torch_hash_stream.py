"""Exact duplicate removal of 150-nt reads through the port's count path,
in the shape of the benchmark's `pcrdup_8m_150nt` configuration cut to a
CPU's size: every read in the 1024-nt bucket (64 lanes), so every
unique_count takes the hash route (kernels I, S, D; their plain versions
here), and 10% of the reads are exact copies of another.

The library is counted whole, and in 3 byte-range slices of 4 chunks
each, the cell's structure in small (3 x (4 chunk counts + 1 chunk
merge) + 1 final merge = 16 hash-route calls).  Each table is held to the
benchmark's plain reference `portbench/reference/count.py` and to the
JAX package's table, array for array; the hash families drawn, the
packed lanes' counter and the ssq.hash_count range are held to what the
library and the path make.  The reference and the library generator are
loaded by path: one copy of each."""

import importlib.util
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import shortseq_torch as st
import shortseq_tpu as sq
from shortseq_torch.count import device as cdev
from shortseq_torch.count import ingest as cingest

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, PORTBENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


ref_count = _load("reference/count.py", "portbench_reference_count")
traffic = _load("traffic.py", "portbench_traffic")

READS = 30_000
NT = 150
#: The configuration's shape at 30,000 reads: 27,000 molecules in equal
#: shares, so 24,000 of one read and 3,000 of two.
LIBRARY = {"reads": READS, "length_min": NT, "length_max": NT,
           "molecules": 27_000, "zipf_s": 0}
SEED = 2**31 + 26
TOP = 20
#: Slices of the streamed case, and the chunk threshold that sends each
#: slice's ~10,000 rows over in 4 chunks.
SLICES = 3
CHUNK_ROWS = 4096
CASES = {"whole": 1, "sliced": SLICES * (4 + 1) + 1}   # hash-route calls


def _counted_families(mp):
    """Count the hash families drawn: each is one _row_hash call (kernel
    I on the card, where _ROW_HASH.launches counts them; its plain
    version here)."""
    drawn = []
    row_hash = cdev._row_hash

    def counted(*args):
        drawn.append(1)
        return row_hash(*args)

    mp.setattr(cdev, "_row_hash", counted)
    return drawn


def _ranges(prof, name):
    return [(e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name == name]


@pytest.fixture(scope="module")
def library(tmp_path_factory):
    path = tmp_path_factory.mktemp("pcrdup") / "lib.fastq"
    traffic.write(LIBRARY, SEED, path)
    return str(path)


@pytest.fixture(scope="module")
def reference(library):
    return ref_count.count_fastq(library)


@pytest.fixture(scope="module")
def jax_table(library):
    return sq.read_and_count_fastq_table(library, engine="device")


@pytest.fixture(scope="module", params=sorted(CASES))
def counted(request, library):
    """(case, table, (families, lane bytes), profiler) of one
    device-engine call of the case under torch.profiler."""
    env = {}
    if request.param == "sliced":
        env = {"SHORTSEQ_TORCH_STREAM_BYTES":
               str(os.path.getsize(library) // SLICES + 1),
               "SHORTSEQ_TORCH_H2D_CHUNK_ROWS": str(CHUNK_ROWS)}
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        drawn = _counted_families(mp)
        before = cingest.packed_buckets.lane_bytes
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            table = st.read_and_count_fastq_table(library, engine="device",
                                                  device="cpu")
        grown = (len(drawn), cingest.packed_buckets.lane_bytes - before)
    return request.param, table, grown, prof


def _live(table):
    """The one bucket's live (words, lengths, counts) as host arrays."""
    assert len(table._buckets) == 1
    b = table._buckets[0]
    assert b.width == 64
    n = b.n_unique
    return tuple(np.asarray(a[:n]) for a in (b.words, b.lengths, b.counts))


def test_library_sizes(reference):
    counts = reference.counts
    assert reference.reads == READS == int(counts.sum())
    assert (int((counts == 1).sum()), int((counts == 2).sum())) == \
        (24_000, 3_000)
    assert int(counts.max()) == 2
    assert bool((reference.keys[:, 0] == NT).all())


def test_table_is_the_reference(counted, reference):
    _, table, _, _ = counted
    words, lengths, counts = _live(table)
    keys = torch.cat([torch.from_numpy(lengths.astype(np.int64))[:, None],
                      torch.from_numpy(words.view(np.uint32)
                                       .astype(np.int64))], 1)
    assert ref_count.rows_wrong(keys, torch.from_numpy(counts), reference) \
        == 0
    assert table.total() == READS and len(table) == 27_000
    listed = table.most_common(TOP)
    assert [c for _, c in listed] == ref_count.top_counts(reference, TOP)
    seqs = [str(k) for k, _ in listed]
    assert len(set(seqs)) == TOP
    assert ref_count.lookup(reference, ref_count.encode(seqs, 10)) == \
        [c for _, c in listed]


def _bits(a):
    """uint32 lanes as int32, the port's dtype for the same bits."""
    return a.view(np.int32) if a.dtype == np.uint32 else a


def test_table_is_jax(counted, jax_table):
    _, table, _, _ = counted
    (want,) = [tuple(np.asarray(a[:b.n_unique])
                     for a in (b.words, b.lengths, b.counts))
               for b in jax_table._buckets]
    for got, exp in zip(_live(table), want):
        np.testing.assert_array_equal(_bits(got), _bits(exp))


def test_counters(counted):
    case, _, grown, prof = counted
    families, lane_bytes = grown
    # Random 150-nt reads: no hash family collides, one family a call.
    assert families == len(_ranges(prof, "ssq.hash_count")) == CASES[case]
    assert lane_bytes == READS * 64 * 4


def test_hash_range_inside_unique_count(counted):
    case, _, _, prof = counted
    hashed = _ranges(prof, "ssq.hash_count")
    outer = _ranges(prof, "ssq.unique_count")
    assert len(hashed) == len(outer) == CASES[case]
    for a, b in hashed:
        assert any(lo <= a and b <= hi for lo, hi in outer)


def test_no_hash_range_on_short_reads(tmp_path):
    path = tmp_path / "short.fastq"
    traffic.write({"reads": 2000, "length_min": 15, "length_max": 32,
                   "molecules": 0, "zipf_s": 0}, SEED, path)
    with pytest.MonkeyPatch.context() as mp:
        drawn = _counted_families(mp)
        before = cingest.packed_buckets.lane_bytes
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            table = st.read_and_count_fastq_table(str(path), engine="device",
                                                  device="cpu")
        lane_bytes = cingest.packed_buckets.lane_bytes - before
    assert table.total() == 2000
    assert _ranges(prof, "ssq.unique_count")
    assert not _ranges(prof, "ssq.hash_count")
    assert not drawn
    assert lane_bytes == 2000 * 2 * 4
