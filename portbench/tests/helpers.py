"""Shared by the benchmark's CPU tests."""

import json
import time
from pathlib import Path

import harness


def run_cell(bench, name, tmp_path, seed=7, seconds=0.3, trace=0):
    """One run of cell `name` of `bench` on the CPU: (result, log)."""
    work = tmp_path / f"work-{name}-{seed}-{trace}"
    work.mkdir()
    return harness.measure(bench, bench.cell(name), seed, seconds, trace,
                           "cpu", work, time.perf_counter())


#: The manifest's cells.
CELLS = tuple(w["name"] for w in json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
    ["workloads"])
