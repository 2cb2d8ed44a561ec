"""umi.neighbors_pct: the program's ssq.umi_neighbors ranges
(_neighbor_lists: kernel H, the overflow tier, the fetch of the lists and
their split into one array a row), their union over the traced window, as
a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.umi_neighbors")
