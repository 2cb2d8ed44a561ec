"""UMI deduplication on the card (or on the CPU with device="cpu")."""

from .dedup import dedup_reads, dedup_umis, split_read

__all__ = ["dedup_reads", "dedup_umis", "split_read"]
