"""The plain reference against collections.Counter on tiny FASTQs, its
lookups and its row comparison."""

import collections

import pytest
import torch

import traffic
from reference import count as ref


def fastq(path, reads):
    path.write_text("".join(f"@r\n{s}\n+\n{'I' * len(s)}\n" for s in reads))
    return path


def as_counter(table):
    return collections.Counter(dict(zip(ref.decode(table.keys),
                                        table.counts.tolist())))


def test_against_counter(tmp_path):
    reads = ["ACGT", "ACGT", "TTTTTTTTTTTTTTTTA", "", "GATTACA" * 20, "ACGT",
             "ACG", "TTTTTTTTTTTTTTTTA"]
    table = ref.count_fastq(fastq(tmp_path / "a.fq", reads))
    assert table.reads == len(reads)
    assert as_counter(table) == collections.Counter(reads)
    assert table.lanes == 9  # 140 nt
    assert ref.top_counts(table, 2) == [3, 2]


def test_generated_library(tmp_path):
    path = tmp_path / "g.fq"
    traffic.write({"reads": 4000, "length_min": 20, "length_max": 40,
                   "molecules": 100, "zipf_s": 1.2}, 5, path)
    reads = path.read_text().split("\n")[1::4]
    assert as_counter(ref.count_fastq(path)) == collections.Counter(reads)


def test_lookup_and_encode(tmp_path):
    table = ref.count_fastq(fastq(tmp_path / "a.fq",
                                  ["ACGT", "ACGT", "CCCC" * 9]))
    q = ref.encode(["ACGT", "CCCC" * 9, "GGGG", "ACGN", "A" * 200],
                   table.lanes)
    assert ref.lookup(table, q) == [2, 1, 0, 0, 0]
    assert ref.decode(q[:2]) == ["ACGT", "CCCC" * 9]


def test_rows_wrong(tmp_path):
    table = ref.count_fastq(fastq(tmp_path / "a.fq",
                                  ["ACGT", "ACGT", "CCCC", "GG"]))
    keys, counts = table.keys.clone(), table.counts.clone()
    assert ref.rows_wrong(keys, counts, table) == 0
    wide = torch.cat([keys, torch.zeros((3, 4), dtype=torch.int64)], 1)
    assert ref.rows_wrong(wide, counts, table) == 0  # zero lanes past
    wide[0, -1] = 1
    assert ref.rows_wrong(wide, counts, table) == 2
    counts[1] += 1
    assert ref.rows_wrong(keys, counts, table) == 2
    assert ref.rows_wrong(torch.cat([keys, keys[:1]]),
                          torch.cat([table.counts, table.counts[:1]]),
                          table) == 1
    assert ref.rows_wrong(keys[:2], table.counts[:2], table) == 1


def test_malformed_fastq_raises(tmp_path):
    bad = tmp_path / "b.fq"
    bad.write_text("@r\nACGT\n+\nIII\n")
    with pytest.raises(ValueError):
        ref.count_fastq(bad)
    bad.write_text("@r\nACNT\n+\nIIII\n")
    with pytest.raises(ValueError):
        ref.count_fastq(bad)

