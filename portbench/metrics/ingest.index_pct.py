"""ingest.index_pct: the program's ssq.index ranges (the line index of
the bytes read), their union over the traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.index")
