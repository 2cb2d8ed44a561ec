"""umi.group_pct: the program's ssq.umi_group ranges (the native
_unique_rows passes over the reads and their inserts, the length buckets
and the re-rank into first-occurrence order), their union over the traced
window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.umi_group")
