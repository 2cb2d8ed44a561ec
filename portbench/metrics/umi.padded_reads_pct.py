"""umi.padded_reads_pct: the share (%) of the reads that the UMI path's
ragged grouping took as a padded read matrix, straight from the FASTQ read
(_dedup_reads_ragged.padded_reads), of all the reads it took
(.padded_reads + .list_reads, the latter laid into that form from a list
of bytes), over the window."""

import program_ranges

MODULE = "shortseq_torch.umi.dedup"

PADDED, LISTED = (program_ranges.counter("_dedup_reads_ragged", a,
                                         module=MODULE)
                  for a in ("padded_reads", "list_reads"))
COUNTERS = (PADDED, LISTED) if PADDED and LISTED else ()


def read(run):
    if not COUNTERS or any(c not in run.counters for c in COUNTERS):
        return None
    reads = run.counters[PADDED] + run.counters[LISTED]
    return 100 * run.counters[PADDED] / reads if reads else None
