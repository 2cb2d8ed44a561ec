"""The cell pcrdup-8m.top20 as the benchmark runs it, cut to the CPU: its
configuration's library (150-nt reads, 10% exact duplicates in pairs) at
a small scale, the cell through `harness.measure` with the default path's
structure in small (3 slices of 4 chunks: 16 hash-route calls a library),
a fault planted in the hash route coming out not correct, and its two
per-layer readers of its own on synthetic runs."""

import json
import re
import types

import numpy as np
import pytest

import harness
import tracefile
import traffic
from conftest import tiny_copy
from helpers import run_cell
from manifest import Bench

CELL = "pcrdup-8m.top20"
READS = 9_000
DEVICE = "shortseq_torch.count.device"
INGEST = "shortseq_torch.count.ingest"


def config():
    bench = Bench()
    _, cfg = bench.config(bench.cell(CELL)["config"])
    return cfg


def test_the_configuration():
    cfg = config()
    lib = cfg["library"]
    assert (lib["length_min"], lib["length_max"], lib["zipf_s"]) == \
        (150, 150, 0)
    # 10% of the reads are copies of another; the cut keeps the ratio.
    assert lib["reads"] - lib["molecules"] == lib["reads"] // 10
    cut = cfg["cut"]
    assert set(cut) - {"why"} == set(cfg["reduced"])
    assert {k: v[1] for k, v in cut.items() if k != "why"} == \
        {k: lib[k] for k in cfg["reduced"]}
    assert cut["reads"][0] - cut["molecules"][0] == cut["reads"][0] // 10


@pytest.mark.parametrize("seed", [5, 2**33 + 7])
def test_library_sizes(seed):
    """At 1/1000 of the configuration: 6,400 molecules of one read and
    800 of two, every read 150 nt, the file 307 bytes a read."""
    lib = dict(config()["library"], reads=8_000, molecules=7_200)
    lengths, rows = traffic.library(lib, seed)
    assert len(lengths) == 8_000 and set(lengths.tolist()) == {150}
    reads = rows(150, np.arange(8_000))
    _, sizes = np.unique(reads, axis=0, return_counts=True)
    assert (int((sizes == 1).sum()), int((sizes == 2).sum()),
            len(sizes)) == (6_400, 800, 7_200)


@pytest.fixture
def bench(tmp_path, monkeypatch):
    """A tiny copy with the cell's library at READS reads, streamed in 3
    slices of 4 chunks each, as the card's library is at the defaults."""
    b = tiny_copy(tmp_path / "bench", reads=READS)
    monkeypatch.setenv("SHORTSEQ_TORCH_STREAM_BYTES",
                       str(READS * 307 // 3 + 1))
    monkeypatch.setenv("SHORTSEQ_TORCH_H2D_CHUNK_ROWS", "512")
    return b


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_through_the_harness(bench, tmp_path, trace):
    result, log = run_cell(bench, CELL, tmp_path, seed=2**31 + 261,
                           trace=trace)
    assert result["correct"], (result["checks"], log)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["checks"] == {k: {"value": 0, "limit": 0}
                                for k in ("calls_wrong", "table_rows_wrong")}
    if not trace:
        assert set(result["metrics"]) == {"reads_per_s", "peak_device_mib",
                                          "peak_host_rss_mib", "setup_s"}
        return
    # The CPU has no device events: the device's readers find nothing.
    assert set(result["metrics"]) == {
        m["name"] for m in bench.metrics(CELL, True)} - {
        "unique_count_roofline", "unique_count.device_ms"}
    assert result["metrics"]["pack.lane_fill_pct"]["value"] == \
        100 * 2 * 150 / (8 * 256)
    assert 0 < result["metrics"]["hash_count_pct"]["value"] < 100
    # Every unique_count of the library takes the hash route.
    line = next(x for x in log
                if x.startswith("probe of unique_count_roofline: "))
    calls = int(re.findall(r"(\d+) calls", line)[0])
    assert calls == 16 * result["attempted"]


def test_a_fault_is_not_correct(bench, tmp_path, monkeypatch):
    """Each merge of tables (weights above 1) loses one read of a pair."""
    from shortseq_torch.count import device as cdev

    orig = cdev._hash_count

    def lossy(words, lengths, weights, n_out):
        u_words, u_lengths, counts, n_unique = orig(words, lengths,
                                                    weights, n_out)
        pairs = (counts == 2).nonzero()
        if weights.max() > 1 and len(pairs):
            counts = counts.clone()
            counts[pairs[0]] = 1
        return u_words, u_lengths, counts, n_unique

    monkeypatch.setattr(cdev, "_hash_count", lossy)
    result, log = run_cell(bench, CELL, tmp_path, seed=2**31 + 263)
    assert result["correct"] is False, log
    assert result["failed"] == 0  # wrong answers, not errors
    assert result["checks"]["calls_wrong"]["value"] == result["attempted"]
    assert result["checks"]["table_rows_wrong"]["value"] > 0


def ev(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def synthetic():
    """A 100 us window over two calls, each with one ssq.hash_count range
    inside its ssq.unique_count, one kernel launched inside each hash
    range and one launched outside both."""
    return [
        ev(tracefile.WINDOW, 0, 100),
        ev("ssq.unique_count", 10, 20), ev("ssq.hash_count", 12, 15),
        ev("ssq.unique_count", 60, 20), ev("ssq.hash_count", 62, 10),
        ev("cudaLaunchKernel", 13, 1, "cuda_runtime", correlation=1),
        ev("row_hash_kernel", 14, 4, "kernel", correlation=1),
        ev("cudaLaunchKernel", 63, 1, "cuda_runtime", correlation=2),
        ev("sort_pass_kernel", 64, 2, "kernel", correlation=2),
        ev("cudaLaunchKernel", 90, 1, "cuda_runtime", correlation=3),
        ev("group_tile_kernel", 91, 5, "kernel", correlation=3),
    ]


def run_of(events=None, counters=None, calls=2, hbm=3.35e12, probes=None):
    return types.SimpleNamespace(
        trace=None if events is None else tracefile.Trace(events),
        calls=[{"ok": True}] * calls, counters=counters or {},
        hbm_bytes_per_s=hbm, reads=10, probes=probes or {})


def test_hash_count_pct():
    reader = Bench().reader("hash_count_pct")
    assert reader.read(run_of(synthetic())) == pytest.approx(25.0)
    assert reader.read(run_of(None)) is None
    # A program without the range (the parent of this cell): nothing.
    absent = [e for e in synthetic() if e["name"] != "ssq.hash_count"]
    assert reader.read(run_of(absent)) is None


def test_lane_fill():
    reader = Bench().reader("pack.lane_fill_pct")
    assert reader.COUNTERS == (f"{INGEST}:packed_buckets.lane_bytes",)
    assert isinstance(harness.counter_value(reader.LANE_BYTES), int)
    probes = {"pack.lane_fill_pct": types.SimpleNamespace(bytes=150)}
    # 150 nt in 64 lanes
    assert reader.read(run_of(counters={reader.LANE_BYTES: 256},
                              probes=probes)) == pytest.approx(14.6484375)
    assert reader.read(run_of(counters={reader.LANE_BYTES: 0},
                              probes=probes)) is None
    # A program without the counter (the parent of this cell): nothing.
    assert reader.read(run_of(counters={}, probes=probes)) is None
    assert reader.read(run_of(counters={reader.LANE_BYTES: 256})) is None


def test_lane_fill_probe_adds_the_bases():
    """The probe wraps gather_pack and adds up the lengths of the rows
    that packed_buckets hands it, before their padding; undo puts the
    function back."""
    import shortseq_torch as st
    from shortseq_torch.count import ingest
    from shortseq_torch.io import fastq

    reader = Bench().reader("pack.lane_fill_pct")
    fn = fastq.gather_pack
    p = reader.probe(types.SimpleNamespace(
        package=st, modules=harness.program_modules()))
    assert fastq.gather_pack is not fn
    p.reset()
    lengths = np.array([150, 150, 20], np.int64)
    rows = np.frombuffer(b"A" * 320, np.uint8)
    before = ingest.packed_buckets.lane_bytes
    parts = list(ingest.packed_buckets(rows, np.array([0, 150, 300]),
                                       lengths, min_pad=4))
    assert [w.shape for w, _ in parts] == [(4, 2), (4, 64)]
    assert (p.calls, p.bytes) == (2, 320)
    assert ingest.packed_buckets.lane_bytes - before == 4 * 8 + 4 * 256
    p.undo()
    assert fastq.gather_pack is fn


def test_the_manifest_entries():
    m = Bench().manifest
    rate = next(x for x in m["end_to_end"] if x["name"] == "reads_per_s")
    assert CELL in rate["workloads"]
    listed = [x for x in m["per_layer"] if CELL in x.get("workloads", ())]
    mine = [x["name"] for x in listed if x["workloads"] == [CELL]]
    assert mine == ["hash_count_pct", "pack.lane_fill_pct"]
    # The count path's readers of the streamed cell read this cell too.
    shared = [x for x in listed if x["workloads"] != [CELL]]
    assert all(x["workloads"] == ["smallrna-10m.streamed", CELL]
               for x in shared)
    assert {x["name"] for x in shared} == {
        x["name"] for x in m["per_layer"]
        if "smallrna-10m.streamed" in x.get("workloads", ())}
    assert all(x["moves"] == "reads_per_s" for x in listed)
    assert json.dumps(m).count(CELL) == 1 + 1 + len(listed)
