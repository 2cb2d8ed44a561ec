"""The cell umi-mirna.directional's check against faults planted where
the CLI's ragged reads now go, the length-bucketed grouping over the
padded read matrix (dedup_fastq hands it read_fastq_matrix's matrix and
lengths, with no call of dedup_reads): a read lost before the grouping,
and a read's label moved to a molecule of another insert, each come out
not correct."""

import functools

import pytest

from helpers import run_cell
from test_portbench_umi_directional import CELL, bench  # noqa: F401


def read_lost(orig):
    """The last row of the matrix never reaches the grouping."""
    def f(mat, lengths, *args, **kwargs):
        return orig(mat[:-1], lengths[:-1], *args, **kwargs)
    return f


def read_moved(orig):
    """The first read's label points at a molecule of another insert."""
    def f(*args, **kwargs):
        labels, molecules = orig(*args, **kwargs)
        mine = molecules[labels[0]][0]
        labels = labels.copy()
        labels[0] = next(i for i, m in enumerate(molecules)
                         if m[0] != mine)
        return labels, molecules
    return f


@pytest.mark.parametrize("fault", [read_lost, read_moved])
def test_a_ragged_path_fault_is_not_correct(bench, tmp_path,  # noqa: F811
                                           monkeypatch, fault):
    from shortseq_torch.umi import dedup

    orig = dedup._dedup_reads_ragged
    # wraps copies _dedup_reads_ragged's counters onto the broken one.
    monkeypatch.setattr(dedup, "_dedup_reads_ragged",
                        functools.wraps(orig)(fault(orig)))
    result, log = run_cell(bench, CELL, tmp_path, seed=2**31 + 103)
    assert result["correct"] is False, log
    assert result["failed"] == 0  # wrong answers, not errors
    assert result["checks"]["reads_wrong"]["value"] > 0
