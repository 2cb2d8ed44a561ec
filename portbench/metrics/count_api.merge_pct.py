"""count_api.merge_pct: the program's ssq.merge ranges (the streamed
path's merge of its slices' tables: concatenation, copies and its
unique_count), their union over the traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.merge")
