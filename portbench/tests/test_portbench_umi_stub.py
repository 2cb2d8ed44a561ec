"""A UMI deduplication cell needs no edit of the harness: a stub entry
(umi_stub_entry.py) that runs `dedup_reads(len_3p=12)` on a UMI-tagged
library of traffic.py, and works out its reference from the count table
that the harness hands it, runs through `harness.measure` and
`control.readings` in a tiny copy of the benchmark, with its own
control in the program's place."""

import json
import shutil
from pathlib import Path

import pytest

import control
import manifest
import umi_stub_entry
from conftest import tiny_copy
from helpers import run_cell
from reference import count as ref_count

CELL = "umi-tiny.directional"
#: 300 molecules of 20 inserts, 10 reads each, a 12-nt UMI at the 3'
#: end with 1% of its bases substituted: about 330 error reads, which
#: directional clustering folds back into their molecules.
LIBRARY = {"reads": 3000, "length_min": 18, "length_max": 25,
           "molecules": 300, "zipf_s": 0, "inserts": 20,
           "insert_zipf_s": 1.0, "umi_3p": 12,
           "umi_substitution_rate": 0.01}


def umi_bench(dst: Path) -> manifest.Bench:
    """A tiny copy of the benchmark with the stub's configuration, mix,
    entry and cell added, as a later PR would add them: new files,
    manifest entries, and the cell's name in the rate's `workloads`."""
    tiny_copy(dst)
    here = dst / "portbench"
    shutil.copy(Path(umi_stub_entry.__file__),
                here / "entries" / "umi_stub.py")
    (here / "mixes" / "umi_directional.json").write_text(json.dumps(
        {"entry": "umi_stub", "len_3p": 12, "env": {},
         "loop": "closed, one client"}))
    (here / "configs" / "umi_tiny.json").write_text(json.dumps(
        {"name": "umi_tiny", "library": LIBRARY}))
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "umi_tiny", "source": "test",
                             "file": "portbench/configs/umi_tiny.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "umi_tiny",
                               "traffic": "umi_directional", "chips": 1,
                               "why": "test"})
    rate = next(x for x in bench["end_to_end"] if x["name"] == "reads_per_s")
    rate["workloads"].append(CELL)
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return manifest.Bench(dst, here)


@pytest.fixture
def bench(tmp_path):
    return umi_bench(tmp_path / "bench")


def test_the_stub_reference_has_work_to_do(tmp_path):
    import traffic

    path = tmp_path / "lib.fq"
    traffic.write(LIBRARY, 2**31 + 11, path)
    ref = ref_count.count_fastq(path)
    want = umi_stub_entry.molecules_by_insert(ref, 12)
    assert len(want) == LIBRARY["inserts"]
    # Error UMIs fold into their molecules: far fewer molecules than
    # distinct reads, and not below the molecules drawn.
    assert LIBRARY["molecules"] <= sum(want.values()) \
        < ref.counts.numel() - 200


def test_directional_rule():
    # A parent of 10 takes its one-base neighbours of 1 to 5 (10 >= 2n - 1)
    # but not one of 6, and a child of 1 passes on to its own neighbour
    # of 1; a UMI two bases away stays apart.
    counts = {"AAAA": 10, "AAAC": 5, "AAGA": 6, "CAAC": 1, "AATT": 1}
    assert umi_stub_entry.directional(counts) == 3


@pytest.mark.parametrize("seed", [7, 2**31 + 11])
def test_a_umi_entry_runs_through_the_harness(bench, tmp_path, seed):
    result, log = run_cell(bench, CELL, tmp_path, seed=seed)
    assert result["correct"], (result["checks"], log)
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"reads_per_s", "setup_s"} <= set(result["metrics"])
    assert result["checks"] == {k: {"value": 0, "limit": 0}
                                for k in umi_stub_entry.LIMITS}


def test_a_umi_entry_brings_its_own_control(bench):
    rows = control.readings(bench, bench.cell(CELL), [1, 2], device="cpu")
    for seed, mine, theirs in rows:
        assert mine == {"calls_wrong": 0, "inserts_wrong": 0}, seed
        assert theirs["calls_wrong"] == 1 and theirs["inserts_wrong"] > 0, \
            (seed, theirs)
