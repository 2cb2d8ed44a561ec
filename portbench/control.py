#!/usr/bin/env python3
"""The readings that a cell's limits are set from: for each seed, the
numbers the cell compares, read once from the program (one call of the
cell's entry, as the window makes it) and once from the control.  One
JSON line a seed, then a summary line.

    python3 portbench/control.py --workload <name> --seeds 1,2,3

The control is the plain reference one precision step down, put in the
program's place: reads grouped by their length and a 32-bit hash of
their lanes (each group keyed by its first read) and counts wrapped to
int16, as a tempting shortcut would.  It stands in for the program
behind the entry's own call (`ControlProgram`), so the entry reads and
judges it exactly as it does the program.  An entry whose call this
control cannot serve brings its own: its `control_program()` returns the
object put in the program's place.

On the card by default; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import random
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import harness  # noqa: E402
import manifest  # noqa: E402
import spans as spans_mod  # noqa: E402
import traffic  # noqa: E402
from reference import count as ref_count  # noqa: E402

_M32 = 0xFFFFFFFF


def hash32(keys):
    """A 32-bit hash of each int64 key row (values below 2**32)."""
    import torch

    h = torch.full((keys.shape[0],), 0x9E3779B9, dtype=torch.int64,
                   device=keys.device)
    for j in range(keys.shape[1]):
        h = ((h ^ keys[:, j]) * 0x85EBCA6B) & _M32
        h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def group_low(keys):
    """(rows, counts) of the key rows grouped by (length, 32-bit hash):
    each group keyed by its first row, its count wrapped to int16."""
    import torch

    if keys.shape[0] == 0:
        return keys, torch.zeros(0, dtype=torch.int64, device=keys.device)
    by = torch.stack([keys[:, 0], hash32(keys)], 1)
    uniq, inverse, counts = torch.unique(by, dim=0, return_inverse=True,
                                         return_counts=True)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inverse, torch.arange(
        keys.shape[0], device=keys.device), "amin")
    rows, order = torch.unique(keys[first], dim=0, return_inverse=True)
    # Distinct hashes of distinct first rows: `order` is a permutation.
    c = torch.zeros_like(counts).index_add_(0, order, counts)
    return rows, c.to(torch.int16).to(torch.int64)


def count_low(path, device="cpu") -> ref_count.Table:
    keys, reads = ref_count.parse(path, device)
    rows, counts = group_low(keys)
    return ref_count.Table(rows, counts, reads)


class _Key:
    """A key of the control's dict: str() is its read."""

    __slots__ = ("table", "i")

    def __init__(self, table, i):
        self.table, self.i = table, i

    def __str__(self):
        return ref_count.decode(self.table.keys[self.i:self.i + 1])[0]

    def __hash__(self):
        return self.i

    def __eq__(self, other):
        return isinstance(other, _Key) and other.i == self.i


class ControlCounter:
    """The control's table seen as the dict that to_counter() returns."""

    def __init__(self, table):
        self.table = table
        self.counts = table.counts.cpu().numpy()

    def __len__(self):
        return len(self.counts)

    def __iter__(self):
        return (_Key(self.table, i) for i in range(len(self.counts)))

    def __getitem__(self, key):
        return int(self.counts[key.i])

    def values(self):
        return iter(self.counts)


class ControlTable:
    """The control's table seen as the program's CountTable."""

    _read_seconds = 0.0

    def __init__(self, table: ref_count.Table):
        self.table = table
        keys = table.keys
        self._buckets = [SimpleNamespace(
            words=keys[:, 1:], lengths=keys[:, 0], counts=table.counts,
            n_unique=keys.shape[0])]

    def __len__(self):
        return self.table.counts.numel()

    def total(self):
        return int(self.table.counts.sum())

    def most_common(self, n):
        import torch

        c = self.table.counts
        order = torch.argsort(c, descending=True, stable=True)[:n]
        reads = ref_count.decode(self.table.keys[order])
        return [(r, int(k)) for r, k in zip(reads, c[order])]

    def to_counter(self):
        return ControlCounter(self.table)


class ControlProgram:
    """The control in the program's place, for an entry's call."""

    @staticmethod
    def read_and_count_fastq_table(path, engine="device", device="cpu"):
        return ControlTable(count_low(path, device))


def readings(bench, cell, seeds, device="cuda"):
    """[(seed, program numbers, control numbers)] of `cell`."""
    import torch

    import shortseq_torch as st

    _, config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    entry = bench.entry(mix["entry"])
    low = entry.control_program() if hasattr(entry, "control_program") \
        else ControlProgram
    out = []
    with harness.environment(mix.get("env", {})), \
            tempfile.TemporaryDirectory(prefix="portbench-") as d:
        fastq = Path(d) / "library.fastq"
        harness.build(torch.device(device))
        for seed in seeds:
            traffic.write(config["library"], seed, fastq)
            ref = ref_count.count_fastq(fastq, device)
            numbers = []
            for program in (st, low):
                sp = spans_mod.Spans()
                sp.new_call()
                with contextlib.redirect_stdout(io.StringIO()):
                    answer, kept, _ = entry.call(program, str(fastq), mix,
                                                 sp, device)
                numbers.append(entry.check([answer], kept, ref, mix,
                                           random.Random(seed)))
                del kept
            out.append((seed, *numbers))
            del ref
    return out


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    args = p.parse_args(argv)
    bench = manifest.Bench()
    cell = bench.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    t0 = time.perf_counter()
    rows = readings(bench, cell, seeds)
    for seed, mine, theirs in rows:
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": mine, "control": theirs}))
    keys = sorted({k for _, _, t in rows for k in t})
    summary = {k: {"program_max": max(m[k] for _, m, _ in rows),
                   "control_min": min(t[k] for _, _, t in rows)}
               for k in keys}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "seconds": time.perf_counter() - t0,
                      "readings": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
