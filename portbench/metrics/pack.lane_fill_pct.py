"""pack.lane_fill_pct: the share (%) of the packed lanes' bits that hold
bases, over the window: 2 bits a base over 8 bits a byte of the lanes
the host packed (the program's packed_buckets.lane_bytes).  The bases are
the lengths of the rows handed to gather_pack, which packed_buckets calls
on each bucket's rows before their padding, added up by a probe of the
traced run, so the program sums nothing for it.  The rest of the lanes is the
padding of each width bucket, which the pack, the copies and the merge
carry all the same."""

import numpy as np

import program_ranges
import roofline

MODULE = "shortseq_torch.count.ingest"
PACK = "shortseq_torch.io.fastq"

LANE_BYTES = program_ranges.counter("packed_buckets", "lane_bytes",
                                    module=MODULE)
COUNTERS = (LANE_BYTES,) if LANE_BYTES else ()


def bases(args, result) -> int:
    """Bases of one gather_pack(data, starts, lengths, width) call."""
    return int(np.asarray(args[2]).sum(dtype=np.int64))


def probe(program):
    import importlib

    fastq = importlib.import_module(PACK)
    # CallBytes adds up any measure: here bases, on its .bytes.
    return roofline.CallBytes(fastq.gather_pack, program.modules, bases)


def read(run):
    p = (run.probes or {}).get("pack.lane_fill_pct")
    if not COUNTERS or LANE_BYTES not in run.counters or p is None:
        return None
    lane_bytes = run.counters[LANE_BYTES]
    return 100 * 2 * p.bytes / (8 * lane_bytes) if lane_bytes else None
