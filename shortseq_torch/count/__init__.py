"""Exact deduplication on the device: sort-unique-count (kernel S +
kernel D) over packed lane rows, and the lazy CountTable over its results.

The operation is associative: merging count tables is concatenation + one
more unique_count with the counts as weights (count/checkpoint.py).
"""

from .device import count_batch, counts_to_host, unique_count
from .table import CountTable

__all__ = ["unique_count", "count_batch", "counts_to_host", "CountTable"]
