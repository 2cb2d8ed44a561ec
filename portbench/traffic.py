"""The one generator of the benchmark's libraries: a configuration's
`library` block and a seed in, one FASTQ file out.

Parameters of the `library` block:
  reads        number of FASTQ records
  length_min   shortest read, in nt
  length_max   longest read, in nt
  molecules    0: every read drawn base by base; N > 0: reads are copies
               of N molecules (PCR duplicate families)
  zipf_s       with molecules: family sizes in Zipf(s) proportions by rank

Lengths are a fixed multiset (each length of [min, max] in equal shares,
the remainder to the shortest) in an order drawn from the seed, and
Zipf families are fixed by largest remainder: every seed gives the same
sizes, and the seed moves only the bases and the order.

Run as a program (the harness starts it in a child process, so that its
arrays stay out of the measuring process):

    python3 portbench/traffic.py CONFIG.json SEED OUT.fastq
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np

ALPHABET = np.frombuffer(b"ACGT", np.uint8)


def rng_for(seed: int) -> np.random.Generator:
    """The generator of `seed` (any integer; negative ones fold into
    64 bits)."""
    return np.random.default_rng(int(seed) & ((1 << 64) - 1))


def balanced_lengths(rng, n: int, lo: int, hi: int) -> np.ndarray:
    """n lengths, each of lo..hi in equal shares (the remainder to the
    shortest), in an order drawn from rng."""
    span = hi - lo + 1
    lens = (np.arange(n, dtype=np.int64) % span + lo).astype(np.int64)
    rng.shuffle(lens)
    return lens


def zipf_sizes(n_keys: int, total: int, s: float) -> np.ndarray:
    """Sizes of n_keys families that sum to `total`, in proportion to
    rank^-s, rounded by largest remainder (the same for every seed)."""
    p = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** s
    share = p / p.sum() * total
    sizes = np.floor(share).astype(np.int64)
    short = total - int(sizes.sum())
    if short:
        sizes[np.argsort(-(share - sizes), kind="stable")[:short]] += 1
    return sizes


def write_records(path, lengths, rows, chunk=1 << 20):
    """One 4-line record per read ('@r', the read, '+', all-'I'
    quality), vectorized over chunks of reads: rows(L, idx) gives the
    [len(idx), L] uint8 bases of the reads idx, all of length L."""
    lengths = np.asarray(lengths, np.int64)
    with open(path, "wb") as f:
        for lo in range(0, len(lengths), chunk):
            ln = lengths[lo:lo + chunk]
            rec = 2 * ln + 7
            start = np.cumsum(rec) - rec
            out = np.full(int(rec.sum()), ord("I"), np.uint8)
            out[start] = ord("@")
            out[start + 1] = ord("r")
            out[start + 2] = ord("\n")
            out[start + 3 + ln] = ord("\n")
            out[start + 4 + ln] = ord("+")
            out[start + 5 + ln] = ord("\n")
            out[start + 6 + 2 * ln] = ord("\n")
            for length in np.unique(ln):
                idx = np.flatnonzero(ln == length)
                dest = (start[idx] + 3)[:, None] + np.arange(length)
                out[dest] = rows(int(length), lo + idx)
            f.write(out.tobytes())
        # On disk before the window opens: no writeback of the file
        # competes with the calls that read it.
        f.flush()
        os.fsync(f.fileno())


def library(spec: dict, seed: int):
    """(lengths int64, rows) of the library `spec` at `seed`, for
    write_records."""
    rng = rng_for(seed)
    n = int(spec["reads"])
    lo, hi = int(spec["length_min"]), int(spec["length_max"])
    n_mol = int(spec.get("molecules") or 0)
    if n_mol <= 0:
        def fresh(length, idx):
            return ALPHABET[rng.integers(0, 4, size=(len(idx), length),
                                         dtype=np.uint8)]

        return balanced_lengths(rng, n, lo, hi), fresh
    mol_len = balanced_lengths(rng, n_mol, lo, hi)
    # Each length's molecules as one [count, length] table; a molecule's
    # row in its length's table.
    pools, row_of = {}, np.empty(n_mol, np.int64)
    for length in np.unique(mol_len):
        mine = np.flatnonzero(mol_len == length)
        row_of[mine] = np.arange(len(mine))
        pools[int(length)] = ALPHABET[rng.integers(
            0, 4, size=(len(mine), int(length)), dtype=np.uint8)]
    pick = np.repeat(np.arange(n_mol), zipf_sizes(n_mol, n,
                                                  float(spec["zipf_s"])))
    rng.shuffle(pick)

    def copies(length, idx):
        return pools[length][row_of[pick[idx]]]

    return mol_len[pick], copies


def write(spec: dict, seed: int, out) -> int:
    """Write the library's FASTQ to `out`; returns its number of reads."""
    lengths, rows = library(spec, seed)
    write_records(out, lengths, rows)
    return len(lengths)


def main(argv) -> int:
    config, seed, out = argv
    spec = json.loads(Path(config).read_text())["library"]
    write(spec, int(seed), out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
