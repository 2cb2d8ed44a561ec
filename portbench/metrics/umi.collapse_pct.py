"""umi.collapse_pct: the program's ssq.umi_collapse ranges (the lists
into a CSR, the directional walk, the relabel, the molecule tuples and the
reads per molecule), their union over the traced window, as a share of
it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.umi_collapse")
