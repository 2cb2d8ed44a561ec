"""UMI-tools' directional deduplication through the port's CLI path,
`umi.dedup.dedup_fastq` (`python -m shortseq_torch umi FILE --len-3p 12`),
against the benchmark's plain reference `portbench/reference/umi.py`, on
libraries in the shape of the benchmark's `qiaseq_mirna_umi`
configuration (mature-miRNA-length inserts, a 12-nt 3' UMI, five reads a
molecule, so counts tie everywhere), cut to a CPU's size.  The reference
and the library generator are loaded by path: one copy of each."""

import collections
import importlib.util
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import shortseq_torch as st
from shortseq_torch.__main__ import main as torch_main
from shortseq_tpu.__main__ import main as jax_main

PORTBENCH = Path(__file__).resolve().parent.parent / "portbench"


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, PORTBENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


ref_umi = _load("reference/umi.py", "portbench_reference_umi")
ref_count = _load("reference/count.py", "portbench_reference_count")
traffic = _load("traffic.py", "portbench_traffic")

UMI = 12
#: The configuration's shape at 4,000 reads: 800 molecules of 5 reads
#: over 20 inserts of 18-25 nt, a 1% substitution rate in the UMIs.
LIBRARY = {"reads": 4000, "length_min": 18, "length_max": 25,
           "molecules": 800, "zipf_s": 0, "inserts": 20,
           "insert_zipf_s": 1.0, "umi_3p": UMI,
           "umi_substitution_rate": 0.01}
SEEDS = [3, 2**31 + 17]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions' many small torch ops on one thread: a loaded
    host's thread pool makes each of them slower, not faster."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", params=SEEDS)
def library(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("umi") / "lib.fastq"
    traffic.write(LIBRARY, request.param, path)
    reads = path.read_bytes().split(b"\n")[1::4]
    return path, reads


def _by_insert(molecules, reads_per_molecule):
    mols, reads = collections.Counter(), collections.Counter()
    for (insert, _), n in zip(molecules, np.asarray(reads_per_molecule)):
        mols[insert] += 1
        reads[insert] += int(n)
    return {k: (mols[k], reads[k]) for k in mols}


def test_dedup_fastq_is_the_reference(library):
    path, reads = library
    molecules, per_molecule = st.dedup_fastq(str(path), len_3p=UMI,
                                             device="cpu")
    labels, want, want_per = ref_umi.from_reads(reads, UMI)
    assert molecules == want
    np.testing.assert_array_equal(per_molecule, want_per)
    got_labels, got = st.dedup_reads(reads, len_3p=UMI, device="cpu")
    np.testing.assert_array_equal(got_labels, labels)
    assert got == want
    # Error UMIs were folded back: fewer molecules than distinct reads.
    assert LIBRARY["molecules"] <= len(molecules) < len(set(reads)) - 100


def test_count_table_answers_are_tie_order_free(library):
    path, reads = library
    by = ref_umi.molecules_by_insert(ref_count.count_fastq(path), UMI)
    rng = random.Random(5)
    tables = set()
    for _ in range(3):
        shuffled = reads[:]
        rng.shuffle(shuffled)
        _, molecules, per = ref_umi.from_reads(shuffled, UMI)
        assert _by_insert(molecules, per) == by
        tables.add(tuple(molecules))
        # The port breaks ties by first occurrence too.
        _, got = st.dedup_reads(shuffled, len_3p=UMI, device="cpu")
        assert got == molecules
    assert len(tables) > 1  # the order moved the table, not the answers
    assert sum(r for _, r in by.values()) == len(reads)


def test_ties_pick_the_members_not_the_number():
    # Two roots of 3 reads, two bases apart, share a neighbour of 1 read:
    # the root that comes first takes it.  Either way two molecules.
    ins = b"ACGTACGTACGTACGTACGT"
    x, y, z = b"AAAAAAAAAAAA", b"AAAAAAAAAACC", b"AAAAAAAAAAAC"
    tables = {}
    for first in (x, y):
        other = y if first is x else x
        reads = [ins + u for u in (first, other, z, first, other, first,
                                   other)]
        labels, molecules, per = ref_umi.from_reads(reads, UMI)
        got_labels, got = st.dedup_reads(reads, len_3p=UMI, device="cpu")
        np.testing.assert_array_equal(got_labels, labels)
        assert got == molecules
        tables[first] = dict(zip((u for _, u in molecules), per.tolist()))
    assert tables[x] == {x: 4, y: 3} and tables[y] == {y: 4, x: 3}
    table = ref_count.Table(*ref_count.group(ref_umi.encode(reads)),
                            len(reads))
    assert ref_umi.molecules_by_insert(table, UMI) == {ins: (2, 7)}


def test_directional_rule():
    # A parent of 10 takes its one-base neighbours of 1 to 5
    # (10 >= 2n - 1) but not one of 6, and a child of 1 passes on to its
    # own neighbour of 1; a UMI two bases away stays apart.
    counts = {"AAAA": 10, "AAAC": 5, "AAGA": 6, "CAAC": 1, "AATT": 1}
    reads = [f"GGG{u}" for u, n in counts.items() for _ in range(n)]
    table = ref_count.Table(*ref_count.group(ref_umi.encode(reads)),
                            len(reads))
    assert ref_umi.molecules_by_insert(table, 4) == {b"GGG": (3, 23)}
    _, molecules = st.dedup_reads(reads, len_3p=4, device="cpu")
    assert sorted(u for _, u in molecules) == [b"AAAA", b"AAGA", b"AATT"]


def test_unique_fails_the_check(library):
    """The benchmark's control (method "unique", no error correction)
    gives other molecules per insert than the count table's reference,
    and the same reads per insert."""
    path, _ = library
    by = ref_umi.molecules_by_insert(ref_count.count_fastq(path), UMI)
    got = _by_insert(*st.dedup_fastq(str(path), len_3p=UMI,
                                     method="unique", device="cpu"))
    assert set(got) == set(by)
    assert sum(got[k][0] != by[k][0] for k in by) > 0
    assert all(got[k][1] == by[k][1] for k in by)


@pytest.mark.parametrize("extra", [[], ["--json"], ["--top", "7"]])
def test_cli_umi_goes_through_dedup_fastq(library, capsys, monkeypatch,
                                          extra):
    """`umi FILE --len-3p 12` prints what the JAX package's CLI prints,
    byte for byte, and takes dedup_fastq to do it."""
    from shortseq_torch.umi import dedup

    path, _ = library
    argv = ["umi", str(path), "--len-3p", str(UMI), *extra]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    calls = []
    orig = dedup.dedup_fastq

    def counted(*args, **kwargs):
        calls.append(args)
        return orig(*args, **kwargs)

    monkeypatch.setattr(dedup, "dedup_fastq", counted)
    assert torch_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert calls == [(str(path),)]
    assert got.out == want.out and got.err == want.err
    assert len(got.out) > 100
