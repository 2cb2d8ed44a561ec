"""umi.self_pct: the program's ssq.umi_dedup ranges (the root of each
dedup_fastq call) less every other ssq.* range inside them: the call's
own code between its stages, over the traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.self_share(run, "ssq.umi_dedup")
