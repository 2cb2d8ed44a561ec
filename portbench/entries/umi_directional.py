"""Entry `umi_directional`: one library through
`dedup_fastq(path, len_3p=..., threshold=..., method=...)`, the path of
`python -m shortseq_torch umi FILE --len-3p 12`: the FASTQ read, then
UMI-tools' directional deduplication of its reads, grouped by insert.

Answers of a call: its number of molecules.  The kept output is one
call's molecule table ((insert, UMI) of each molecule and its reads),
drawn from the seed.

The harness hands `check` the reference's count table, which holds no
order of occurrence: the program breaks count ties by first occurrence in
the file, so which key represents a molecule, and which molecule takes a
key that two can reach, may differ with the order.  So the check compares
what the count table fixes whatever the order (reference/umi.py
`molecules_by_insert`), each with limit 0:
  calls_wrong    calls whose number of molecules is not the reference's
  inserts_wrong  inserts whose number of molecules in the kept table is
                 not the reference's
  reads_wrong    inserts whose reads in the kept table (summed over their
                 molecules) are not the count table's

The control is the program without error correction (method "unique":
every distinct UMI its own molecule).
"""

from __future__ import annotations

import collections
from types import SimpleNamespace

from reference import umi as ref_umi

#: Each compared number's limit (exact comparisons: 0).
LIMITS = {"calls_wrong": 0, "inserts_wrong": 0, "reads_wrong": 0}


def call(st, path, mix, spans, device):
    with spans.span("portbench.umi_dedup"):
        molecules, reads = st.dedup_fastq(
            path, len_3p=int(mix["len_3p"]), threshold=int(mix["threshold"]),
            method=mix["method"], device=device)
    return {"molecules": len(molecules)}, (molecules, reads), 0.0


def control_program():
    import shortseq_torch

    def dedup_fastq(path, **kwargs):
        return shortseq_torch.dedup_fastq(path, **{**kwargs,
                                                   "method": "unique"})

    return SimpleNamespace(dedup_fastq=dedup_fastq)


def check(answers, kept, ref, mix, rng) -> dict:
    want = ref_umi.molecules_by_insert(ref, int(mix["len_3p"]))
    total = sum(m for m, _ in want.values())
    molecules, reads = kept
    got_mols, got_reads = collections.Counter(), collections.Counter()
    for (insert, _), n in zip(molecules, reads.tolist()):
        got_mols[insert] += 1
        got_reads[insert] += n
    inserts = set(want) | set(got_mols)
    return {"calls_wrong": sum(a["molecules"] != total for a in answers),
            "inserts_wrong": sum(got_mols[k] != want.get(k, (0, 0))[0]
                                 for k in inserts),
            "reads_wrong": sum(got_reads[k] != want.get(k, (0, 0))[1]
                               for k in inserts)}
