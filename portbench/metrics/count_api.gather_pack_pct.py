"""count_api.gather_pack_pct: the program's ssq.gather_pack ranges (host
gather + 2-bit pack + validate, one a width bucket), their union over the
traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.gather_pack")
