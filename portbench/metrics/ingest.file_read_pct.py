"""ingest.file_read_pct: the program's ssq.file_read ranges (the FASTQ's
bytes read into memory, one a streamed slice), their union over the
traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.file_read")
