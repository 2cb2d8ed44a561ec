"""Entry `table_top`: one library through
`read_and_count_fastq_table(path, engine="device")`, then
`most_common(top)` and `total()` of the lazy table (the in-process form
of `count --top N`).

Answers of a call: its top list, its total and its number of unique
rows; the whole table of one call drawn from the seed is kept too.
Compared with the reference:
  table_rows_wrong  rows by which the kept table departs from the
                    reference's (repeated rows plus the symmetric
                    difference of the (key, count) rows)
  calls_wrong       calls whose total, unique rows or top list differ:
                    the top counts must be the reference's top counts,
                    and each listed (read, count) the reference's; which
                    of the rows tied at the last count are listed is the
                    program's row order, and any of them is right
"""

from __future__ import annotations

import torch

from reference import count as ref_count

#: Each compared number's limit (exact comparisons: 0).
LIMITS = {"calls_wrong": 0, "table_rows_wrong": 0}


def call(st, path, mix, spans, device):
    top = int(mix["top"])
    with spans.span("portbench.count"):
        table = st.read_and_count_fastq_table(path, engine="device",
                                              device=device)
    with spans.span(f"portbench.top{top}"):
        listed = table.most_common(top)
        total = table.total()
    answer = {"top": [(str(k), int(c)) for k, c in listed], "total": total,
              "unique": len(table)}
    return answer, table, table._read_seconds


def rows(table):
    """(keys int64 [M, 1 + W], counts int64 [M]) of a CountTable's live
    rows, every bucket's lanes zero-padded to the widest."""
    keys, counts = [], []
    width = max((b.words.shape[1] for b in table._buckets), default=1)
    for b in table._buckets:
        n = b.n_unique
        words = torch.as_tensor(b.words[:n]).to(torch.int64) & 0xFFFFFFFF
        pad = words.new_zeros((n, width - words.shape[1]))
        lengths = torch.as_tensor(b.lengths[:n]).to(torch.int64)
        keys.append(torch.cat([lengths[:, None], words, pad], 1))
        counts.append(torch.as_tensor(b.counts[:n]).to(torch.int64))
    if not keys:
        return torch.zeros((0, 1 + width), dtype=torch.int64), \
            torch.zeros(0, dtype=torch.int64)
    dev = keys[0].device
    return (torch.cat([k.to(dev) for k in keys]),
            torch.cat([c.to(dev) for c in counts]))


def top_wrong(listed, ref, n: int) -> bool:
    want = ref_count.top_counts(ref, n)
    if [c for _, c in listed] != want:
        return True
    seqs = [s for s, _ in listed]
    if len(set(seqs)) != len(seqs):
        return True
    got = ref_count.lookup(ref, ref_count.encode(seqs, ref.lanes))
    return got != [c for _, c in listed]


def check(answers, kept, ref, mix, rng) -> dict:
    n = int(mix["top"])
    wrong, seen = 0, {}
    for a in answers:
        key = tuple(a["top"])
        if key not in seen:
            seen[key] = top_wrong(a["top"], ref, n)
        wrong += (seen[key] or a["total"] != ref.reads
                  or a["unique"] != ref.counts.numel())
    return {"calls_wrong": wrong,
            "table_rows_wrong": ref_count.rows_wrong(*rows(kept), ref)}

