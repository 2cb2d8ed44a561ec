"""umi_neighbors_roofline: the least time the card could take for the
window's neighbour searches, over the device time launched inside the
program's ssq.umi_neighbors ranges.

The least time is the larger of two bounds, counted from the problem and
not from what implements it (bound_s):
  compares  every ordered pair of candidates inside one insert
            (_neighbor_lists.group_pairs), each a popcount of every
            32-bit lane its UMIs fill (.umi_lanes over .rows), at the
            card's popcount rate;
  bytes     the candidates' lanes, lengths and group ids read once (4 B
            each) and 4 B written for each neighbour found (.edges), at
            the card's HBM rate.
A search that compares no pairs (looking up each UMI's substitutions, as
reference/umi.py does) does other work than the compares counted here:
such a program needs a `benchmark` change that recounts this bound.
"""

import program_ranges

MODULE = "shortseq_torch.umi.dedup"

#: 32-bit popcounts a second, by torch.cuda.get_device_name(): 132 SMs x
#: 16 a clock x 1.98 GHz (the rate PERF.md's kernel table uses).
POPCOUNTS_PER_S = {
    "NVIDIA H100 80GB HBM3": 4.18e12,
}

NAMES = ("rows", "group_pairs", "umi_lanes", "edges")
SPECS = {a: program_ranges.counter("_neighbor_lists", a, module=MODULE)
         for a in NAMES}
COUNTERS = tuple(SPECS.values()) if all(SPECS.values()) else ()


def bound_s(rows, group_pairs, umi_lanes, edges, popcounts_per_s,
            bytes_per_s) -> float:
    """Seconds the card needs at least for searches of these totals."""
    if not rows:
        return 0.0
    compares = group_pairs * umi_lanes / rows
    moved = 4 * umi_lanes + 8 * rows + 4 * edges
    return max(compares / popcounts_per_s, moved / bytes_per_s)


def read(run):
    if run.trace is None or not run.hbm_bytes_per_s or not COUNTERS \
            or any(c not in run.counters for c in COUNTERS):
        return None
    import torch

    rate = POPCOUNTS_PER_S.get(torch.cuda.get_device_name(0))
    inside = run.trace.launched_in("ssq.umi_neighbors")
    device_s = sum(b - a for a, b, _, _ in inside) / 1e6
    if rate is None or device_s <= 0:
        return None
    least = bound_s(*(run.counters[SPECS[a]] for a in NAMES), rate,
                    run.hbm_bytes_per_s)
    return 100 * least / device_s
