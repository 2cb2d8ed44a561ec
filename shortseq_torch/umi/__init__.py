"""UMI handling on the card (or on the CPU with device="cpu"): the object
layer (`UMI`, `UMI5p`, `UMI3p`, `UMIboth`, `UMIFactory`), deduplication
(`dedup_umis`, `dedup_reads`, and `dedup_fastq`, the CLI's path from a
FASTQ file) and the dense `umi_adjacency`."""

from .dedup import (dedup_fastq, dedup_reads, dedup_umis, split_read,
                    umi_adjacency)
from .objects import UMI, UMI3p, UMI5p, UMIboth, UMIFactory

__all__ = [
    "UMI", "UMI5p", "UMI3p", "UMIboth", "UMIFactory",
    "dedup_fastq", "dedup_reads", "dedup_umis", "split_read",
    "umi_adjacency",
]
