"""umi_neighbors.pairs_ratio: the pairs the neighbour search compared
(_neighbor_lists.pairs: candidate rows x the padded columns of kernel H)
over the pairs the problem holds (_neighbor_lists.group_pairs: the
ordered pairs of candidates inside one insert), over the window.  1 is a
search that compares only pairs of one insert."""

import program_ranges

MODULE = "shortseq_torch.umi.dedup"

PAIRS, GROUP_PAIRS = (program_ranges.counter("_neighbor_lists", a,
                                             module=MODULE)
                      for a in ("pairs", "group_pairs"))
COUNTERS = (PAIRS, GROUP_PAIRS) if PAIRS and GROUP_PAIRS else ()


def read(run):
    if not COUNTERS or any(c not in run.counters for c in COUNTERS):
        return None
    within = run.counters[GROUP_PAIRS]
    return run.counters[PAIRS] / within if within else None
