"""transfer.h2d_bytes_per_read: bytes the program copied to the card (its
h2d helper's .bytes) over the window, per read of the window's finished
calls.  A traced run also prints the trace's host-to-card copies beside
the helper's .copies."""

import program_ranges

BYTES = program_ranges.counter("h2d", "bytes")
COPIES = program_ranges.counter("h2d", "copies")
COUNTERS = (BYTES,) if BYTES else ()
LAUNCHES = {"Memcpy HtoD": COPIES} if COPIES else {}


def read(run):
    return program_ranges.per_read(run, BYTES)
