"""A run with the timed path broken underneath comes out not correct:
each fault planted in the program's unique_count (every count of every
cell goes through it, the streamed merge too), on the CPU at a small
size.  The look for a chip is skipped (device "cpu"); the rest of the
run is the benchmark's own.  One chip: no exchange between chips to
leave out."""

import json

import pytest
import torch

from helpers import CELLS, run_cell


def with_duplicates(bench):
    """The tiny copy's short reads cut to 4-6 nt, so that a library holds
    repeated reads (the 10M-read library does; 3000 reads of 15-32 nt
    do not)."""
    for c in bench.manifest["configs"]:
        path = bench.root / c["file"]
        cfg = json.loads(path.read_text())
        if cfg["library"]["length_max"] <= 32:
            cfg["library"].update(length_min=4, length_max=6)
            path.write_text(json.dumps(cfg))
    return bench


def unchanged(orig):
    """The rows come back as they went in: no grouping.  (The dict of the
    counter cell adds repeated rows up, so there the step that returns
    its state unchanged is the dict's update: no_update.)"""
    def f(words, lengths, weights, n_out=None):
        return words, lengths, weights, torch.tensor(words.shape[0],
                                                     dtype=torch.int32)
    return f


def half(orig):
    """Half of the rows left out, the other half weighted double."""
    def f(words, lengths, weights, n_out=None):
        h = max(1, words.shape[0] // 2)
        return orig(words[:h], lengths[:h], weights[:h] * 2)
    return f


def altered(orig):
    """One count altered where it is produced."""
    def f(words, lengths, weights, n_out=None):
        w, ln, c, n = orig(words, lengths, weights, n_out)
        c = c.clone()
        c[0] += 1
        return w, ln, c, n
    return f


def no_update(orig):
    """The dict's update from a table returns the dict unchanged."""
    def f(counter, words, lengths, counts):
        return None
    return f


def plant(monkeypatch, make):
    import sys

    from shortseq_torch.api import counter
    from shortseq_torch.count import device as cdev

    orig = counter.update_counter_from_host_table if make is no_update \
        else cdev.unique_count
    broken = make(orig)
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] == "shortseq_torch" and mod is not None:
            for attr, value in list(vars(mod).items()):
                if value is orig:
                    monkeypatch.setattr(mod, attr, broken)


@pytest.mark.parametrize("fault", [unchanged, half, altered])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny, tmp_path, monkeypatch, name, fault):
    if fault is unchanged and name.endswith(".counter"):
        fault = no_update
    bench = with_duplicates(tiny)
    result, _ = run_cell(bench, name, tmp_path)
    assert result["correct"], "the sound run must be correct"
    plant(monkeypatch, fault)
    result, log = run_cell(bench, name, tmp_path, seed=8)
    assert result["correct"] is False, log
    assert result["failed"] == 0  # wrong answers, not errors
    assert any(v["value"] > v["limit"] for v in result["checks"].values())
