"""Host-side ingest: indexed FASTQ rows -> packed-word buckets, from
shortseq_tpu/count/ingest.py.

2-bit packing and bloom validation happen during the host gather
(io.fastq.gather_pack), so the device receives packed lanes: 4x less
host->device traffic than ASCII rows, and no separate device validation
pass.  Buckets follow the reference's width ladder (short_seq.pyx:54-74):
<=32 nt -> 2 lanes, <=96 -> 6, <=1024 -> 64.

Unlike the JAX package, batches are not padded to quarter-powers of two:
that padding only kept the set of XLA compile shapes closed, and the
port compiles nothing per shape.
"""

from __future__ import annotations

import numpy as np

from ..constants import MAX_64_NT, MAX_192_NT, MAX_VAR_NT, TOO_LONG_MSG

WIDTH_EDGES = [(0, MAX_64_NT, 32), (MAX_64_NT, MAX_192_NT, 96),
               (MAX_192_NT, MAX_VAR_NT, 1024)]


def bucket_mask(lengths: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Rows of the width bucket (lo, hi]; empty reads join the first."""
    sel = (lengths > lo) & (lengths <= hi)
    if lo == 0:
        sel |= lengths == 0
    return sel


def packed_buckets(data, starts, lengths, batch_size: int | None = None):
    """Yield (words uint32 [M, width//16], sub_len int32 [M]) per width
    bucket, host-packed and host-validated: at most `batch_size` rows per
    yield (the sharded pipeline's device batches), or one batch per bucket
    when it is None.

    Raises the reference's errors: "Unsupported base character: X" on an
    invalid byte, TOO_LONG_MSG past 1024 nt.
    """
    from ..io.fastq import gather_pack

    lengths = np.asarray(lengths)
    if len(lengths) and int(lengths.max()) > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)
    starts = np.asarray(starts)
    for lo, hi, width in WIDTH_EDGES:
        sel = bucket_mask(lengths, lo, hi)
        n_sel = int(np.count_nonzero(sel))
        if n_sel == 0:
            continue
        if n_sel == len(lengths):  # single-bucket file: skip the gather
            s_sel, len_sel = starts, lengths.astype(np.int32, copy=False)
        else:
            s_sel = starts[sel]
            len_sel = lengths[sel].astype(np.int32)
        bs = batch_size or len(len_sel)
        for off in range(0, len(len_sel), bs):
            sub_len = len_sel[off:off + bs]
            yield gather_pack(data, s_sel[off:off + bs], sub_len,
                              width), sub_len
