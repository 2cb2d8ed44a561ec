"""umi.read_pct: the program's ssq.umi_read ranges (dedup_fastq's read of
the FASTQ into a matrix and the reads' ragged list), their union over the
traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.umi_read")
