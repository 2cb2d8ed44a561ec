"""umi.padded_reads_pct reads the ragged UMI grouping's counters, and is
left out where the program has none (the parent of the change that
added them)."""

import types

import pytest

import harness
from manifest import Bench

NAME = "umi.padded_reads_pct"
PADDED = "shortseq_torch.umi.dedup:_dedup_reads_ragged.padded_reads"
LISTED = "shortseq_torch.umi.dedup:_dedup_reads_ragged.list_reads"


def run_of(counters):
    return types.SimpleNamespace(trace=None, calls=[{"ok": True}],
                                 counters=counters, reads=10)


@pytest.mark.parametrize("padded, listed, want",
                         [(2_000_000, 0, 100.0), (3, 1, 75.0),
                          (0, 5, 0.0), (0, 0, None)])
def test_share_of_reads_taken_as_a_padded_matrix(padded, listed, want):
    reader = Bench().reader(NAME)
    assert reader.COUNTERS == (PADDED, LISTED)
    assert all(isinstance(harness.counter_value(c), int)
               for c in reader.COUNTERS)
    got = reader.read(run_of({PADDED: padded, LISTED: listed}))
    assert got == (None if want is None else pytest.approx(want))
    assert reader.read(run_of({})) is None


def test_left_out_where_the_program_has_no_counter(monkeypatch):
    from shortseq_torch.umi import dedup

    monkeypatch.delattr(dedup._dedup_reads_ragged, "padded_reads")
    reader = Bench().reader(NAME)
    assert reader.COUNTERS == ()
    assert reader.read(run_of({PADDED: 1, LISTED: 0})) is None
