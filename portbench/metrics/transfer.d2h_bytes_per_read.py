"""transfer.d2h_bytes_per_read: bytes the program copied from the card
(its d2h helper's .bytes) over the window, per read of the window's
finished calls."""

import program_ranges

BYTES = program_ranges.counter("d2h", "bytes")
COUNTERS = (BYTES,) if BYTES else ()


def read(run):
    return program_ranges.per_read(run, BYTES)
