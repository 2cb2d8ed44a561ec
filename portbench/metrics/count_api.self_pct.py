"""count_api.self_pct: the program's ssq.read_count ranges (the root of
each library call) less every other ssq.* range inside them: the call's
own glue between its stages, over the traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.self_share(run, "ssq.read_count")
