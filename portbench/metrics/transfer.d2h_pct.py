"""transfer.d2h_pct: the program's ssq.d2h ranges (each blocking read of a
card tensor: the wait for the card's queue and the copy), their union
over the traced window, as a share of it."""

import program_ranges


def read(run):
    return program_ranges.share(run, "ssq.d2h")
