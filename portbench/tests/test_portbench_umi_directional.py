"""The cell umi-mirna.directional as the benchmark runs it, cut to the
CPU: its configuration's shape (inserts and molecules scaled with the
reads) through `harness.measure` and `control.readings` with the real
entry, faults planted under the entry coming out not correct, and each of
its per-layer readers on a synthetic traced run."""

import json
import types

import numpy as np
import pytest

import control
import harness
import tracefile
from conftest import tiny_copy
from helpers import run_cell
from manifest import Bench

CELL = "umi-mirna.directional"
READS = 20_000
MODULE = "shortseq_torch.umi.dedup"


@pytest.fixture
def bench(tmp_path):
    """A tiny copy with the cell's library at READS reads: molecules (by
    tiny_copy) and inserts cut alike, the rest as configured."""
    b = tiny_copy(tmp_path / "bench", reads=READS)
    path = b.root / next(c["file"] for c in b.manifest["configs"]
                         if c["name"] == b.cell(CELL)["config"])
    cfg = json.loads(path.read_text())
    lib = cfg["library"]
    full = json.loads((Bench().root / path.relative_to(b.root)).read_text())
    lib["inserts"] = full["library"]["inserts"] * READS \
        // full["library"]["reads"]
    path.write_text(json.dumps(cfg))
    return b


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_through_the_harness(bench, tmp_path, trace):
    result, log = run_cell(bench, CELL, tmp_path, seed=2**31 + 101,
                           trace=trace)
    assert result["correct"], (result["checks"], log)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["checks"] == {k: {"value": 0, "limit": 0} for k in
                                ("calls_wrong", "inserts_wrong",
                                 "reads_wrong")}
    want = {m["name"] for m in bench.metrics(CELL, bool(trace))}
    if trace:
        # The CPU has no device events: the device's readers find nothing.
        want -= {"umi_neighbors.device_ms", "umi_neighbors_roofline"}
        assert len(want) == 7
    else:
        assert want == {"reads_per_s", "peak_device_mib",
                        "peak_host_rss_mib", "setup_s"}
    assert set(result["metrics"]) == want


def test_the_control_fails_the_cell(bench):
    rows = control.readings(bench, bench.cell(CELL), [1, 2], device="cpu")
    for seed, mine, theirs in rows:
        assert mine == {"calls_wrong": 0, "inserts_wrong": 0,
                        "reads_wrong": 0}, seed
        # No error correction: more molecules, the same reads.
        assert theirs["calls_wrong"] == 1 and theirs["inserts_wrong"] > 0 \
            and theirs["reads_wrong"] == 0, (seed, theirs)


def no_collapse(dedup):
    """Every distinct key its own molecule: the walk roots each node."""
    return "_greedy_absorb", lambda neighbors, counts, directional: \
        np.arange(len(neighbors))


def read_lost(dedup):
    """The last read never reaches the deduplication."""
    orig = dedup.dedup_reads

    def f(reads, **kwargs):
        return orig(reads[:-1], **kwargs)
    return "dedup_reads", f


def read_moved(dedup):
    """The first read's label points at a molecule of another insert."""
    orig = dedup.dedup_reads

    def f(reads, **kwargs):
        labels, molecules = orig(reads, **kwargs)
        mine = molecules[labels[0]][0]
        labels = labels.copy()
        labels[0] = next(i for i, m in enumerate(molecules) if m[0] != mine)
        return labels, molecules
    return "dedup_reads", f


@pytest.mark.parametrize("fault", [no_collapse, read_lost, read_moved])
def test_a_fault_is_not_correct(bench, tmp_path, monkeypatch, fault):
    from shortseq_torch.umi import dedup

    name, broken = fault(dedup)
    monkeypatch.setattr(dedup, name, broken)
    result, log = run_cell(bench, CELL, tmp_path, seed=2**31 + 103)
    assert result["correct"] is False, log
    assert result["failed"] == 0  # wrong answers, not errors
    assert any(v["value"] > v["limit"] for v in result["checks"].values())


def ev(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def synthetic():
    """A 100 us window over two calls: the stages of each inside its
    root, and one kernel launched inside ssq.umi_neighbors (and one
    launched outside it)."""
    return [
        ev(tracefile.WINDOW, 0, 100),
        ev("portbench.umi_dedup", 0, 91),
        ev("ssq.umi_dedup", 0, 50), ev("ssq.umi_dedup", 50, 40),
        ev("ssq.umi_read", 0, 10), ev("ssq.umi_read", 50, 10),
        ev("ssq.umi_group", 10, 10), ev("ssq.umi_group", 60, 10),
        ev("ssq.umi_pack", 20, 1), ev("ssq.umi_pack", 70, 1),
        ev("ssq.umi_neighbors", 21, 9), ev("ssq.umi_neighbors", 71, 9),
        ev("ssq.pack_validate", 20, 1),  # a kernel's range in the pack
        ev("ssq.umi_collapse", 30, 8), ev("ssq.umi_collapse", 45, 2),
        ev("ssq.umi_collapse", 80, 7),
        ev("cudaLaunchKernel", 22, 1, "cuda_runtime", correlation=7),
        ev("neighbor_lists_kernel", 24, 6, "kernel", correlation=7),
        ev("cudaLaunchKernel", 39, 1, "cuda_runtime", correlation=8),
        ev("neighbor_lists_kernel", 40, 4, "kernel", correlation=8),
    ]


SPECS = {a: f"{MODULE}:_neighbor_lists.{a}"
         for a in ("rows", "pairs", "group_pairs", "umi_lanes", "edges")}


def run_of(events=None, counters=None, calls=2, hbm=3.35e12):
    return types.SimpleNamespace(
        trace=None if events is None else tracefile.Trace(events),
        calls=[{"ok": True}] * calls, counters=counters or {},
        hbm_bytes_per_s=hbm, reads=10)


SHARES = {"umi.read_pct": 20.0, "umi.group_pct": 20.0, "umi.pack_pct": 2.0,
          "umi.neighbors_pct": 18.0, "umi.collapse_pct": 17.0,
          # [0, 90] less the 77 us of its stages
          "umi.self_pct": 13.0}


@pytest.mark.parametrize("name", sorted(SHARES))
def test_umi_span_readers(name):
    reader = Bench().reader(name)
    assert reader.read(run_of(synthetic())) == pytest.approx(SHARES[name])
    assert reader.read(run_of(None)) is None
    # A program without the UMI ranges (the parent of this cell): nothing.
    absent = [e for e in synthetic() if not e["name"].startswith("ssq.")]
    assert reader.read(run_of(absent)) is None


def test_neighbor_device_ms():
    reader = Bench().reader("umi_neighbors.device_ms")
    # 6 us launched inside the two calls' ranges, over 2 calls
    assert reader.read(run_of(synthetic())) == pytest.approx(0.003)
    assert reader.read(run_of(None)) is None
    assert reader.LAUNCHES == {
        "neighbor_lists_kernel": f"{MODULE}:neighbor_lists_fused.launches"}
    assert isinstance(harness.counter_value(
        reader.LAUNCHES["neighbor_lists_kernel"]), int)


def test_pairs_ratio():
    reader = Bench().reader("umi_neighbors.pairs_ratio")
    assert set(reader.COUNTERS) == {SPECS["pairs"], SPECS["group_pairs"]}
    for spec in reader.COUNTERS:
        assert isinstance(harness.counter_value(spec), int)
    counters = {SPECS["pairs"]: 4000, SPECS["group_pairs"]: 100}
    assert reader.read(run_of(counters=counters)) == 40.0
    assert reader.read(run_of(counters={})) is None
    counters[SPECS["group_pairs"]] = 0
    assert reader.read(run_of(counters=counters)) is None


def test_roofline_bound():
    reader = Bench().reader("umi_neighbors_roofline")
    # compares: 1e6 pairs of one lane at 1e12/s; bytes: 4 * 10 + 8 * 10 +
    # 4 * 30 = 240, at 1e12/s or 1e8/s
    assert reader.bound_s(10, 10**6, 10, 30, 1e12, 1e12) == 1e-6
    assert reader.bound_s(10, 10**6, 10, 30, 1e12, 1e8) == \
        pytest.approx(2.4e-6)
    assert reader.bound_s(10, 10**6, 20, 30, 1e12, 1e12) == 2e-6
    assert reader.bound_s(0, 0, 0, 0, 1e12, 1e12) == 0.0


def test_roofline_reader(monkeypatch):
    import torch

    reader = Bench().reader("umi_neighbors_roofline")
    assert set(reader.COUNTERS) == {SPECS[a] for a in reader.NAMES}
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    counters = {SPECS["rows"]: 1000, SPECS["group_pairs"]: 4.18e6,
                SPECS["umi_lanes"]: 1000, SPECS["edges"]: 0}
    # 4.18e6 one-lane compares at 4.18e12/s: 1 us, over 6 us of device
    assert reader.read(run_of(synthetic(), counters)) == \
        pytest.approx(100 / 6)
    assert reader.read(run_of(synthetic(), counters, hbm=None)) is None
    assert reader.read(run_of(None, counters)) is None
    assert reader.read(run_of(synthetic(), {})) is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "other")
    assert reader.read(run_of(synthetic(), counters)) is None
