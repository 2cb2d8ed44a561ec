"""Entry `table_counter`: one library through
`read_and_count_fastq_table(path, engine="device")`, then `to_counter()`:
the reference-identical dict of ShortSeq objects.

Answers of a call: its number of keys; the whole dict of one call drawn
from the seed is kept too.  Compared with the reference:
  calls_wrong       calls whose dict has another number of keys
  dict_wrong        in the kept dict: the difference in keys, the counts
                    that differ between the two sorted multisets of
                    counts, and the keys of a sample drawn from the seed
                    whose count (of their read, str(key)) is not the
                    reference's
"""

from __future__ import annotations

import numpy as np

from reference import count as ref_count

#: Each compared number's limit (exact comparisons: 0).
LIMITS = {"calls_wrong": 0, "dict_wrong": 0}

SAMPLE = 1 << 14


def call(st, path, mix, spans, device):
    with spans.span("portbench.count"):
        table = st.read_and_count_fastq_table(path, engine="device",
                                              device=device)
    with spans.span("portbench.to_counter"):
        counter = table.to_counter()
    return {"unique": len(counter)}, counter, table._read_seconds


def digest(counter, rng):
    """What check() reads of a dict: its number of keys, every count,
    and (read, count) of a sample of keys drawn from rng."""
    n = len(counter)
    counts = np.fromiter(counter.values(), np.int64, n)
    keys = list(counter)
    pick = sorted(rng.sample(range(n), min(SAMPLE, n)))
    sample = [(str(keys[i]), int(counter[keys[i]])) for i in pick]
    return {"keys": n, "counts": counts, "sample": sample}


def dict_wrong(digest, ref) -> int:
    u = ref.counts.numel()
    wrong = abs(digest["keys"] - u)
    if digest["keys"] == u:
        got = np.sort(digest["counts"])
        wrong += int((got != np.sort(ref.counts.cpu().numpy())).sum())
    reads = [r for r, _ in digest["sample"]]
    want = ref_count.lookup(ref, ref_count.encode(reads, ref.lanes))
    return wrong + sum(c != w for (_, c), w in zip(digest["sample"], want))


def check(answers, kept, ref, mix, rng) -> dict:
    return {"calls_wrong": sum(a["unique"] != ref.counts.numel()
                               for a in answers),
            "dict_wrong": dict_wrong(digest(kept, rng), ref)}
