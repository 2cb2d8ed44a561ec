"""objects.build_pct: the program's ssq.objects ranges (the ShortSeq
objects and the dict's inserts of to_counter), their union over the
traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.objects")
