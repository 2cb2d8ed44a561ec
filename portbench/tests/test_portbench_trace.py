"""The per-layer arithmetic on synthetic trace events: the union of
device intervals and the idle share, the labels of idle time, the work
launched inside a range, and the bytes of unique_count from shapes."""

import types

import pytest
import torch

import roofline
import tracefile
from manifest import Bench


def ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """A 100 us window: portbench.count over [0, 60] holding
    ssq.unique_count over [20, 40], portbench.top20 over [70, 90]; two
    kernels launched inside unique_count (one overlapping the other), a
    copy launched in the count span outside it, and a kernel that runs
    after the window."""
    return [
        ev("user_annotation", tracefile.WINDOW, 0, 100),
        ev("user_annotation", "portbench.count", 0, 60),
        ev("user_annotation", "ssq.unique_count", 20, 20),
        ev("user_annotation", "portbench.top20", 70, 20),
        ev("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 23, 1, corr=2),
        ev("cuda_driver", "cuLaunchKernel", 10, 1, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 95, 1, corr=4),
        ev("kernel", "sort_pass_kernel", 25, 10, corr=1),
        ev("kernel", "group_tile_kernel", 30, 10, corr=2),
        ev("gpu_memcpy", "Memcpy HtoD", 12, 4, corr=3),
        ev("kernel", "late_kernel", 120, 5, corr=4),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 50},
    ]


def test_union_and_idle_share():
    assert tracefile.union([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(0, 3),
                                                                 (5, 7)]
    t = tracefile.Trace(synthetic())
    assert t.window == (0, 100)
    assert t.busy() == [(12, 16), (25, 40)]
    assert t.busy_us() == 19
    assert t.gaps() == [(0, 12), (16, 25), (40, 100)]
    run = types.SimpleNamespace(trace=t)
    from manifest import Bench
    idle = Bench().reader("device.idle_pct").read(run)
    assert idle == pytest.approx(81.0)


def test_idle_labelled_by_the_innermost_range():
    t = tracefile.Trace(synthetic())
    assert t.label(30) == "ssq.unique_count"
    assert t.label(50) == "portbench.count"
    assert t.label(65) == "no range"
    idle = t.idle_by_label()
    # [0,12] and [16,20] in count, [20,25] in unique_count, [40,60] in
    # count, [60,70] none, [70,90] top20, [90,100] none.
    assert idle == {"portbench.count": 36, "ssq.unique_count": 5,
                    "no range": 20, "portbench.top20": 20}
    assert sum(idle.values()) == 100 - t.busy_us()
    top = tracefile.top(idle, 2)
    assert top == [["portbench.count", 36e-6], ["no range", 20e-6]]


def test_work_launched_inside_a_range():
    t = tracefile.Trace(synthetic())
    inside = t.launched_in("ssq.unique_count")
    assert [d[2] for d in inside] == ["sort_pass_kernel",
                                      "group_tile_kernel"]
    assert [d[2] for d in t.launched_in("portbench.count")] == [
        "sort_pass_kernel", "group_tile_kernel", "Memcpy HtoD"]
    assert t.count("kernel") == 2  # late_kernel is outside the window
    assert t.op_totals() == {"sort_pass_kernel": 10,
                             "group_tile_kernel": 10, "Memcpy HtoD": 4}


def test_device_readers_from_the_trace():
    b = Bench()
    t = tracefile.Trace(synthetic())
    probe = types.SimpleNamespace(bytes=67e6)
    run = types.SimpleNamespace(trace=t, calls=[{}, {}], counters={},
                                probes={"unique_count_roofline": probe},
                                hbm_bytes_per_s=3.35e12)
    # 20 us of device work inside the ranges, over 2 libraries.
    assert b.reader("unique_count.device_ms").read(run) == \
        pytest.approx(0.010)
    # 67 MB at 3.35 TB/s is 20 us: the whole of the device time.
    assert b.reader("unique_count_roofline").read(run) == \
        pytest.approx(100.0)
    run.trace = None
    assert b.reader("unique_count_roofline").read(run) is None
    assert b.reader("device.idle_pct").read(run) is None


def test_unique_count_bytes_from_shapes():
    words = torch.zeros((1000, 2), dtype=torch.int32)
    lengths = torch.zeros(1000, dtype=torch.int32)
    weights = torch.ones(1000, dtype=torch.int32)
    table = (torch.zeros((1000, 2), dtype=torch.int32),
             torch.zeros(1000, dtype=torch.int32),
             torch.zeros(1000, dtype=torch.int32),
             torch.zeros((), dtype=torch.int32))
    reader = Bench().reader("unique_count_roofline")
    assert reader.call_bytes((words, lengths, weights), table) == \
        2 * (8000 + 4000 + 4000) + 4


def test_call_bytes_wraps_every_binding():
    def f(a, b, c):
        return (a, b, c, a[:0])

    mods = [types.SimpleNamespace(f=f, g=f), types.SimpleNamespace(f=f)]
    probe = roofline.CallBytes(f, mods, Bench().reader(
        "unique_count_roofline").call_bytes)
    x = torch.zeros(10, dtype=torch.int32)
    mods[0].f(x, x, x)
    mods[1].f(x, x, x)
    mods[0].g(x, x, x)
    assert probe.calls == 3 and probe.bytes == 3 * 6 * 40
    probe.undo()
    assert mods[0].f is f and mods[0].g is f and mods[1].f is f
