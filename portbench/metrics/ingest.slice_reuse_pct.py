"""ingest.slice_reuse_pct: the share (%) of the streamed calls' plain-file
slices that the program read into a host buffer its call already held
(its io.fastq slice_buffer's .reuses), of all the slices it read into one
(.allocs + .reuses), over the window."""

import program_ranges

#: The module whose slice_buffer carries the counters.
MODULE = "shortseq_torch.io.fastq"

ALLOCS, REUSES = (program_ranges.counter("slice_buffer", a, module=MODULE)
                  for a in ("allocs", "reuses"))
COUNTERS = (ALLOCS, REUSES) if ALLOCS and REUSES else ()


def read(run):
    if not COUNTERS or any(c not in run.counters for c in COUNTERS):
        return None
    slices = run.counters[ALLOCS] + run.counters[REUSES]
    return 100 * run.counters[REUSES] / slices if slices else None
