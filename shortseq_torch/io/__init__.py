"""Host I/O: FASTQ parsing and the native host library's bindings."""

from .fastq import read_fastq_matrix

__all__ = ["read_fastq_matrix"]
