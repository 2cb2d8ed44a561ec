"""The run's report: the result as one JSON object on the last line of
standard output, each compared number beside its limit on the last
lines of standard error, after the pattern of tests/test_bench_report.py."""

import json
import subprocess
import sys

import pytest

import harness
from conftest import PORTBENCH, ROOT
from helpers import CELLS, run_cell

KEYS = ("correct", "attempted", "failed", "metrics", "device")


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_result_line(tiny, tmp_path, capsys, name, trace):
    result, log = run_cell(tiny, name, tmp_path, trace=trace)
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] >= 1
    harness.report(result, log)
    out, err = capsys.readouterr()
    last = json.loads(out.splitlines()[-1])
    assert all(k in last for k in KEYS)
    assert list(last)[-1] == "checks"  # the compared numbers come last
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    dev = last["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    tail = err.splitlines()[-len(last["checks"]):]
    for line, (k, v) in zip(tail, last["checks"].items()):
        assert line == f"check {k}: {v['value']} (limit {v['limit']})"
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in last["breakdown"].values())
    else:
        assert "breakdown" not in last


@pytest.mark.parametrize("name", CELLS)
def test_metrics_are_the_cells(tiny, tmp_path, name):
    want = {m["name"] for m in tiny.metrics(name, False)}
    result, _ = run_cell(tiny, name, tmp_path)
    assert set(result["metrics"]) == want
    assert "setup_s" in want and len(want) >= 2
    result, _ = run_cell(tiny, name, tmp_path, seed=8, trace=1)
    layer = {m["name"] for m in tiny.metrics(name, True)}
    # The CPU has no device events: the device's readers find nothing.
    assert set(result["metrics"]) == layer - {
        "unique_count_roofline", "unique_count.device_ms"}


def test_units_follow_the_manifest(tiny, tmp_path):
    result, _ = run_cell(tiny, CELLS[0], tmp_path)
    units = {m["name"]: m["unit"] for m in tiny.manifest["end_to_end"]}
    for k, m in result["metrics"].items():
        assert m["unit"] == units[k]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, str(PORTBENCH / "run.py"), "--workload", CELLS[0],
         "--seed", "2147483653", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_benchmark_alone_fails(tiny, tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, the
    program cannot be imported: the run fails and prints no result."""
    code = ("import sys, time; sys.path[:0] = ['portbench', '.']; "
            "import harness, manifest; b = manifest.Bench(); "
            "w = __import__('pathlib').Path('w'); w.mkdir(); "
            "harness.measure(b, b.cell(%r), 1, 0.1, 0, 'cpu', w, "
            "time.perf_counter())" % CELLS[0])
    proc = subprocess.run([sys.executable, "-c", code], cwd=tiny.root,
                          capture_output=True, text=True, timeout=300,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "shortseq_torch" in proc.stderr
