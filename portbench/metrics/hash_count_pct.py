"""hash_count_pct: the program's ssq.hash_count ranges (unique_count's
route for rows over 6 lanes: each hash family's kernels I, S and D and
the host's blocking read of D's collision word), their union over the
traced window, as a share of it.  None where the program has no such
range."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.hash_count")
