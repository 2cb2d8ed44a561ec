"""The readers of the program's own ranges and transfer counters on a
synthetic trace with nested ranges: each range's union over the window,
clipped to it; the call's own time less the program ranges inside it;
the counters per read and per call; and None wherever the run holds
nothing to read (no trace, a program without the range or counter)."""

import types

import pytest

import harness
import program_ranges
import tracefile
from manifest import Bench


def ev(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def synthetic():
    """A 100 us window.  One call's root starts before it, so its first
    read is clipped; a lazy read runs past its end.  unique_count holds a
    d2h; the harness's own span holds the root and is no program range."""
    return [
        ev(tracefile.WINDOW, 0, 100),
        ev("portbench.count", -10, 71),
        ev("ssq.read_count", -10, 70),       # [0, 60] in the window
        ev("ssq.file_read", -8, 12),         # [0, 4]
        ev("ssq.index", 4, 8),               # [4, 12]
        ev("ssq.gather_pack", 12, 18),       # [12, 30]
        ev("ssq.h2d", 30, 2), ev("ssq.h2d", 33, 2),
        ev("ssq.unique_count", 35, 10),      # [35, 45]
        ev("ssq.d2h", 40, 2), ev("ssq.d2h", 50, 6),
        ev("ssq.merge", 56, 3),              # [56, 59]
        ev("ssq.to_counter", 65, 34),
        ev("ssq.objects", 70, 28),
        ev("ssq.table_read", 99, 6),         # [99, 100] in the window
    ]


def run_of(events=None, calls=2, counters=None, reads=10):
    t = None if events is None else tracefile.Trace(events)
    return types.SimpleNamespace(
        trace=t, calls=[{"ok": True}] * calls, counters=counters or {},
        reads=reads)


SHARES = {"ingest.file_read_pct": 4.0, "ingest.index_pct": 8.0,
          "count_api.gather_pack_pct": 18.0, "count_api.merge_pct": 3.0,
          "transfer.h2d_pct": 4.0, "transfer.d2h_pct": 8.0,
          "objects.build_pct": 28.0,
          # [0, 60] less [0, 32], [33, 45] and [50, 59]
          "count_api.self_pct": 7.0,
          # 1 us over 2 calls
          "table.read_span_ms": 0.0005}


@pytest.mark.parametrize("name", sorted(SHARES))
def test_span_readers(name):
    reader = Bench().reader(name)
    assert reader.read(run_of(synthetic())) == pytest.approx(SHARES[name])
    assert reader.read(run_of(None)) is None
    # A program without the range (the parent of the change that added
    # it): the metric is left out.
    absent = [e for e in synthetic()
              if not e["name"].startswith("ssq.")]
    assert reader.read(run_of(absent)) is None


def test_self_time_of_a_call_with_no_stage():
    run = run_of([ev(tracefile.WINDOW, 0, 10), ev("ssq.read_count", 0, 4),
                  ev("portbench.count", 0, 5)])
    assert program_ranges.self_share(run, "ssq.read_count") == 40.0


def test_overlap_of_interval_lists():
    assert program_ranges._overlap([(0, 5), (8, 12)],
                                   [(3, 9), (11, 20)]) == 2 + 1 + 1


COUNTED = {"transfer.h2d_bytes_per_read": ("h2d", "bytes", 600, 30.0),
           "transfer.d2h_bytes_per_read": ("d2h", "bytes", 320, 16.0),
           "transfer.syncs_per_call": ("d2h", "copies", 8, 4.0)}


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_counter_readers(name):
    helper, attr, growth, want = COUNTED[name]
    reader = Bench().reader(name)
    spec = f"shortseq_torch.count.device:{helper}.{attr}"
    assert spec in reader.COUNTERS
    assert isinstance(harness.counter_value(spec), int)
    # 2 finished calls of 10 reads
    assert reader.read(run_of(counters={spec: growth})) == \
        pytest.approx(want)
    assert reader.read(run_of(counters={})) is None
    assert reader.read(run_of(calls=0, counters={spec: growth})) is None


def test_copies_checked_against_the_trace():
    b = Bench()
    assert b.reader("transfer.h2d_bytes_per_read").LAUNCHES == {
        "Memcpy HtoD": "shortseq_torch.count.device:h2d.copies"}
    assert b.reader("transfer.syncs_per_call").LAUNCHES == {
        "Memcpy DtoH": "shortseq_torch.count.device:d2h.copies"}


def test_no_counter_where_the_program_has_none():
    assert program_ranges.counter("h2d", "nothing") is None
    assert program_ranges.counter("no_helper", "bytes") is None
    assert program_ranges.counter("h2d", "bytes",
                                  module="no_such_module") is None


def test_counter_of_another_module():
    fastq = "shortseq_torch.io.fastq"
    assert program_ranges.counter("slice_buffer", "reuses", module=fastq) \
        == f"{fastq}:slice_buffer.reuses"
    assert program_ranges.counter("slice_buffer", "reuses") is None
    assert program_ranges.counter("slice_buffer", "nothing",
                                  module=fastq) is None
