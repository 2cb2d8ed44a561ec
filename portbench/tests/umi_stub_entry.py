"""A stub entry of a UMI deduplication cell, for the CPU tests: it shows
that an entry whose output is not a count table runs through the
harness and control.py as they stand.

The call reads the FASTQ and runs `dedup_reads(reads, len_3p=...)`, the
directional method at threshold 1.  The reference is worked out from the
count table that the harness hands every entry: its distinct reads,
grouped by insert, are clustered by a plain directional walk (UMI-tools'
rule: edge a -> b where the UMIs differ in one base and
n_a >= 2 * n_b - 1; from each unassigned UMI by descending count, every
UMI reachable along edges joins its cluster).

Answers of a call: its number of molecules; the molecules of one call
are kept.  Compared with the reference:
  calls_wrong    calls whose number of molecules is not the reference's
  inserts_wrong  in the kept molecules: inserts whose number of
                 molecules is not the reference's

The control is the program without error correction (method "unique"):
every distinct UMI its own molecule.
"""

from __future__ import annotations

import collections
import functools
import time
from types import SimpleNamespace

from reference import count as ref_count

LIMITS = {"calls_wrong": 0, "inserts_wrong": 0}


def read_fastq(path) -> list:
    with open(path, "rb") as f:
        return f.read().split(b"\n")[1::4]


def call(st, path, mix, spans, device):
    t0 = time.perf_counter()
    reads = read_fastq(path)
    read_s = time.perf_counter() - t0
    with spans.span("portbench.dedup"):
        _, molecules = st.dedup_reads(reads, len_3p=mix["len_3p"],
                                      device=device)
    return {"molecules": len(molecules)}, molecules, read_s


def control_program():
    import shortseq_torch

    return SimpleNamespace(dedup_reads=functools.partial(
        shortseq_torch.dedup_reads, method="unique"))


def neighbours(umi: str):
    for i, base in enumerate(umi):
        for other in "ACGT":
            if other != base:
                yield umi[:i] + other + umi[i + 1:]


def directional(counts: dict) -> int:
    """The number of clusters of the UMIs {umi: count} of one insert."""
    assigned, clusters = set(), 0
    for root in sorted(counts, key=lambda u: (-counts[u], u)):
        if root in assigned:
            continue
        clusters += 1
        assigned.add(root)
        stack = [root]
        while stack:
            node = stack.pop()
            for nbr in neighbours(node):
                if (nbr in counts and nbr not in assigned
                        and counts[node] >= 2 * counts[nbr] - 1):
                    assigned.add(nbr)
                    stack.append(nbr)
    return clusters


def molecules_by_insert(ref, len_3p: int) -> dict:
    """{insert: number of molecules} of the reference's count table."""
    groups = collections.defaultdict(dict)
    for read, n in zip(ref_count.decode(ref.keys), ref.counts.tolist()):
        groups[read[:len(read) - len_3p]][read[len(read) - len_3p:]] = n
    return {ins: directional(umis) for ins, umis in groups.items()}


def check(answers, kept, ref, mix, rng) -> dict:
    want = molecules_by_insert(ref, mix["len_3p"])
    got = collections.Counter(ins.decode("ascii") for ins, _ in kept)
    total = sum(want.values())
    return {"calls_wrong": sum(a["molecules"] != total for a in answers),
            "inserts_wrong": sum(got[k] != want.get(k, 0)
                                 for k in set(got) | set(want))}
