"""table.read_span_ms: the program's ssq.table_read ranges (the lazy
table's reads: most_common, total, lookups) inside the traced window, ms
a library call."""

import program_ranges


def read(run):
    us = program_ranges.span_us(run, "ssq.table_read")
    return None if us is None or not run.calls else us / 1e3 / len(run.calls)
