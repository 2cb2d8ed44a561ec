"""The end-to-end and host-span readers over a run's record: the rate
over the whole window, the spans' shares, the peaks."""

import types

import pytest

from manifest import Bench


def call(wall, read_s=0.0, ok=True, **spans):
    return {"wall": wall, "read_s": read_s, "ok": ok,
            "spans": {k.replace("__", "."): v for k, v in spans.items()}}


@pytest.fixture
def bench():
    return Bench()


@pytest.mark.parametrize("name", ["reads_per_s", "reads_per_s.counter"])
def test_rate_counts_finished_reads_over_the_whole_window(bench, name):
    run = types.SimpleNamespace(calls=[call(1.0), call(1.0, ok=False),
                                       call(1.0)],
                                reads=1000, window_s=4.0)
    assert bench.reader(name).read(run) == 500.0


def test_span_shares(bench):
    calls = [call(0.6, 0.3, portbench__count=0.5, portbench__top20=0.1),
             call(0.8, 0.4, portbench__count=0.6, portbench__top20=0.2)]
    run = types.SimpleNamespace(calls=calls, window_s=2.0)
    assert bench.reader("ingest.read_index_pct").read(run) == \
        pytest.approx(35.0)
    assert bench.reader("count_api.count_pct").read(run) == \
        pytest.approx(20.0)
    assert bench.reader("table.reads_ms").read(run) == pytest.approx(150.0)
    assert bench.reader("objects.to_counter_pct").read(run) is None
    run.calls = [call(3.0, 0.3, portbench__count=0.5,
                      portbench__to_counter=2.5)]
    assert bench.reader("objects.to_counter_pct").read(run) == \
        pytest.approx(125.0)
    assert bench.reader("table.reads_ms").read(run) is None


def test_peaks_in_mib(bench):
    run = types.SimpleNamespace(peak_device_bytes=3 << 20,
                                peak_rss_bytes=5 << 20, setup_s=9.5)
    assert bench.reader("peak_device_mib").read(run) == 3.0
    assert bench.reader("peak_host_rss_mib").read(run) == 5.0
    assert bench.reader("setup_s").read(run) == 9.5
