"""Count-table merges, from shortseq_tpu/count/checkpoint.py:120-165.

Counting is associative, so merging N host tables is one concatenation +
one unique_count with the counts as weights.  The streamed count path
merges its per-slice tables here.  Spilling, loading and resuming tables
come with the pipeline slice.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..ops.lanes import from_numpy_u32
from .device import empty_table, unique_count

__all__ = ["empty_table", "merge_host_tuples"]


def merge_host_tuples(host_tables, n_out: int | None = None, device="cuda"):
    """Merge host (words uint32 [M, W], lengths int32 [M], counts [M])
    tuples exactly: one zero-padded concat + one unique_count on `device`
    ("cuda" raises without a card; "cpu" runs the plain versions).
    Narrower tables are zero-padded to the widest width.  Returns the
    (u_words, u_lengths, u_counts, n_unique) tensors on `device`, with
    n_out rows when given (an n_out below the group count keeps the first
    n_out groups, and fetch_table raises on the table).

    Counts are narrowed to int32, as in the JAX package; a count that does
    not fit wraps and is the caller's to avoid (every table this package
    produces holds int32 counts)."""
    device = _build.resolve_device(device)
    widths = [w.shape[1] for w, _, _ in host_tables if w.size]
    width = max(widths) if widths else 1
    total = sum(len(l) for _, l, _ in host_tables)
    if total == 0:
        return empty_table(width, device)
    words = np.zeros((total, width), np.uint32)
    lengths = np.empty(total, np.int32)
    counts = np.empty(total, np.int32)
    row = 0
    for w, l, c in host_tables:
        words[row:row + len(l), :w.shape[1]] = w
        lengths[row:row + len(l)] = l
        counts[row:row + len(l)] = c
        row += len(l)
    return unique_count(from_numpy_u32(words).to(device),
                        torch.from_numpy(lengths).to(device),
                        torch.from_numpy(counts).to(device), n_out=n_out)
