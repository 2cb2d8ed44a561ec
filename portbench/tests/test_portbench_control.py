"""The control (the reference one precision step down, in the program's
place) reads above every limit, and the program reads 0, at a size that
a test run holds: three 15-nt molecules in 70,000 reads, so that the
largest count passes int16.  On the card, at each cell's own size,
`python3 portbench/control.py --workload <cell> --seeds ...` takes the
same readings (PERF.md gives them)."""

import json

import pytest
import torch

import control
from helpers import CELLS
from reference import count as ref
from test_portbench_reference import fastq


def wrapping_libraries(bench):
    """Every library of `bench` cut to three 15-nt molecules in 70,000
    reads, on which the default control fails."""
    for c in bench.manifest["configs"]:
        path = bench.root / c["file"]
        cfg = json.loads(path.read_text())
        lo = cfg["library"]["length_min"]
        cfg["library"].update(reads=70_000, molecules=3, zipf_s=1.2,
                              length_min=lo, length_max=lo)
        path.write_text(json.dumps(cfg))


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(tiny, name):
    wrapping_libraries(tiny)
    entry = tiny.entry(tiny.mix(tiny.cell(name)["traffic"])["entry"])
    rows = control.readings(tiny, tiny.cell(name), [1, 2, 3], device="cpu")
    for seed, mine, theirs in rows:
        assert set(mine) == set(theirs) == set(entry.LIMITS)
        assert all(mine[k] <= entry.LIMITS[k] for k in mine), (seed, mine)
        assert any(theirs[k] > entry.LIMITS[k] for k in theirs), (seed,
                                                                  theirs)


OWN_CONTROL = """

def control_program():
    import shortseq_torch

    return shortseq_torch
"""


@pytest.mark.parametrize("name", CELLS)
def test_an_entry_brings_its_own_control(tiny, name):
    # The entry's control_program() is put in the program's place: here
    # the program itself, which reads 0 where the default control fails.
    wrapping_libraries(tiny)
    entry = tiny.here / "entries" / (
        tiny.mix(tiny.cell(name)["traffic"])["entry"] + ".py")
    entry.write_text(entry.read_text() + OWN_CONTROL)
    rows = control.readings(tiny, tiny.cell(name), [1], device="cpu")
    for seed, mine, theirs in rows:
        assert theirs == mine and not any(mine.values()), (seed, theirs)


def test_control_wraps_counts_to_int16(tmp_path):
    path = fastq(tmp_path / "w.fq", ["ACGT"] * 40000 + ["GG"] * 3)
    exact = ref.count_fastq(path)
    ctrl = control.count_low(path)
    assert sorted(exact.counts.tolist()) == [3, 40000]
    assert sorted(ctrl.counts.tolist()) == [40000 - 65536, 3]
    assert ref.rows_wrong(ctrl.keys, ctrl.counts, exact) == 2


def test_control_merges_hash_collisions():
    # Two distinct rows of one length that share a 32-bit hash (about 19
    # pairs are expected among 400,000 rows of two random lanes).
    g = torch.Generator().manual_seed(1)
    keys = torch.cat([torch.full((400_000, 1), 40),
                      torch.randint(0, 2**32, (400_000, 2), generator=g)], 1)
    h = control.hash32(keys)
    order = torch.argsort(h)
    same = (h[order][1:] == h[order][:-1]).nonzero().flatten()
    assert same.numel(), "no collision among 400,000 rows"
    i, j = order[same[0]], order[same[0] + 1]
    rows, counts = control.group_low(keys[torch.stack([i, j])])
    assert rows.shape[0] == 1 and counts.tolist() == [2]
    rows, counts = ref.group(keys[torch.stack([i, j])])
    assert rows.shape[0] == 2


def test_control_table_reads_like_the_programs(tmp_path):
    path = fastq(tmp_path / "t.fq", ["ACGT"] * 3 + ["GG"] * 5 + ["T"])
    table = control.ControlProgram.read_and_count_fastq_table(str(path))
    assert len(table) == 3 and table.total() == 9
    assert table.most_common(2) == [("GG", 5), ("ACGT", 3)]
    d = table.to_counter()
    assert sorted((str(k), d[k]) for k in d) == [("ACGT", 3), ("GG", 5),
                                                 ("T", 1)]
