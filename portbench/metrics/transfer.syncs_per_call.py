"""transfer.syncs_per_call: the program's blocking reads of card tensors
(its d2h helper's .copies: each one waits for the card) over the window,
per library call.  A traced run also prints the trace's card-to-host
copies beside them."""

import program_ranges

COPIES = program_ranges.counter("d2h", "copies")
COUNTERS = (COPIES,) if COPIES else ()
LAUNCHES = {"Memcpy DtoH": COPIES} if COPIES else {}


def read(run):
    if COPIES is None or COPIES not in run.counters or not run.calls:
        return None
    return run.counters[COPIES] / len(run.calls)
