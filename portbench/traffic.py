"""The one generator of the benchmark's libraries: a configuration's
`library` block and a seed in, one FASTQ file out.

Parameters of the `library` block:
  reads        number of FASTQ records
  length_min   shortest read, in nt
  length_max   longest read, in nt
  molecules    0: every read drawn base by base; N > 0: reads are copies
               of N molecules (PCR duplicate families)
  zipf_s       with molecules: family sizes in Zipf(s) proportions by rank

A UMI-tagged library (absent or 0, these keys leave the draws and the
file as without them; set, it needs `molecules`, `inserts` and `umi_3p`
all > 0):
  inserts                the molecules' inserts come from a pool of K
                         distinct sequences, insert j (by rank) holding a
                         Zipf(insert_zipf_s) share of the molecules
  insert_zipf_s          the Zipf exponent of those shares
  umi_3p                 each molecule carries a UMI of that many random
                         bases at the 3' end: a read is insert + UMI
                         (length_min and length_max stay the insert's)
  umi_substitution_rate  each base of each read's UMI is replaced, with
                         this probability, by one of the other three,
                         uniformly; inserts are copied exactly

Lengths are a fixed multiset (each length of [min, max] in equal shares,
the remainder to the shortest) in an order drawn from the seed, and
Zipf families and insert groups are fixed by largest remainder: every
seed gives the same sizes, and the seed moves only the bases and the
order.  A UMI library's substitutions are drawn last, as the file is
written: at one seed, libraries that differ only in the rate hold the
same molecules in the same order.

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


#: The library keys of a UMI-tagged library.
UMI_KEYS = ("inserts", "insert_zipf_s", "umi_3p",
            "umi_substitution_rate")


def library(spec: dict, seed: int):
    """(lengths int64, rows) of the library `spec` at `seed`, for
    write_records."""
    rng = rng_for(seed)
    n = int(spec["reads"])
    lo, hi = int(spec["length_min"]), int(spec["length_max"])
    n_mol = int(spec.get("molecules") or 0)
    if any(spec.get(k) for k in UMI_KEYS):
        return umi_library(spec, rng, n, lo, hi, n_mol)
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


def distinct_pool(rng, n: int, lo: int, hi: int):
    """n distinct random sequences, as base codes 0-3: ({length: [count,
    length] uint8 table}, length of each sequence, its row in its length's
    table).  Sequence j is lo + j % (hi - lo + 1) long for every seed, so
    that the lengths of the groups they head are fixed too.  A repeated
    sequence is drawn again."""
    seq_len = lo + np.arange(n, dtype=np.int64) % (hi - lo + 1)
    pools, row_of = {}, np.empty(n, np.int64)
    for length in map(int, np.unique(seq_len)):
        mine = np.flatnonzero(seq_len == length)
        if len(mine) > 4 ** length:
            raise ValueError(f"{len(mine)} distinct sequences of {length} "
                             f"nt do not exist")
        row_of[mine] = np.arange(len(mine))
        table = rng.integers(0, 4, size=(len(mine), length), dtype=np.uint8)
        while True:
            _, first = np.unique(table.view(np.dtype((np.void, length))),
                                 return_index=True)
            again = np.setdiff1d(np.arange(len(mine)), first)
            if not again.size:
                break
            table[again] = rng.integers(0, 4, size=(again.size, length),
                                        dtype=np.uint8)
        pools[length] = table
    return pools, seq_len, row_of


def umi_library(spec, rng, n, lo, hi, n_mol):
    """library() of a UMI-tagged library (the module's docstring)."""
    n_ins, u3 = int(spec.get("inserts") or 0), int(spec.get("umi_3p") or 0)
    rate = float(spec.get("umi_substitution_rate") or 0)
    if min(n_mol, n_ins, u3) <= 0 or not 0 <= rate < 1:
        raise ValueError("a UMI library needs molecules, inserts and umi_3p "
                         "> 0, and umi_substitution_rate in [0, 1)")
    pools, ins_len, ins_row = distinct_pool(rng, n_ins, lo, hi)
    # Insert j holds a Zipf share of the molecules; each insert's molecules
    # are spread evenly over the family-size ranks, so every insert's
    # families follow one shape, and reads per insert are the same for
    # every seed.
    group = zipf_sizes(n_ins, n_mol, float(spec.get("insert_zipf_s") or 0))
    mol_ins = np.repeat(np.arange(n_ins), group)
    within = np.arange(n_mol) - np.repeat(np.cumsum(group) - group, group)
    mol_ins = mol_ins[np.argsort((within + 0.5) / group[mol_ins],
                                 kind="stable")]
    umis = rng.integers(0, 4, size=(n_mol, u3), dtype=np.uint8)
    pick = np.repeat(np.arange(n_mol), zipf_sizes(n_mol, n,
                                                  float(spec["zipf_s"])))
    rng.shuffle(pick)

    def tagged(length, idx):
        mol = pick[idx]
        umi = umis[mol]
        if rate:
            hit = rng.random(umi.shape, dtype=np.float32) < rate
            umi[hit] = (umi[hit] + rng.integers(
                1, 4, size=int(hit.sum()), dtype=np.uint8)) % 4
        body = pools[length - u3][ins_row[mol_ins[mol]]]
        return ALPHABET[np.concatenate([body, umi], 1)]

    return u3 + ins_len[mol_ins[pick]], tagged


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
