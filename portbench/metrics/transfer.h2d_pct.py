"""transfer.h2d_pct: the program's ssq.h2d ranges (each copy to the card:
pinning and the copy's launch, or a pageable copy whole), their union
over the traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.h2d")
