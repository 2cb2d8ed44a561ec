"""ingest.slice_reuse_pct reads the program's slice_buffer counters, and
is left out where the program has none (the parent of the change that
added them)."""

import types

import pytest

import harness
from manifest import Bench

NAME = "ingest.slice_reuse_pct"
ALLOCS = "shortseq_torch.io.fastq:slice_buffer.allocs"
REUSES = "shortseq_torch.io.fastq:slice_buffer.reuses"


def run_of(counters):
    return types.SimpleNamespace(trace=None, calls=[{"ok": True}],
                                 counters=counters, reads=10)


@pytest.mark.parametrize("allocs, reuses, want",
                         [(1, 2, 200 / 3), (17, 34, 200 / 3), (5, 0, 0.0),
                          (0, 0, None)])
def test_share_of_slices_read_into_a_held_buffer(allocs, reuses, want):
    reader = Bench().reader(NAME)
    assert reader.COUNTERS == (ALLOCS, REUSES)
    assert all(isinstance(harness.counter_value(c), int)
               for c in reader.COUNTERS)
    got = reader.read(run_of({ALLOCS: allocs, REUSES: reuses}))
    assert got == (None if want is None else pytest.approx(want))
    assert reader.read(run_of({})) is None


def test_left_out_where_the_program_has_no_counter(monkeypatch):
    import shortseq_torch.io.fastq as fastq

    monkeypatch.delattr(fastq, "slice_buffer")
    reader = Bench().reader(NAME)
    assert reader.COUNTERS == ()
    assert reader.read(run_of({ALLOCS: 1, REUSES: 2})) is None
