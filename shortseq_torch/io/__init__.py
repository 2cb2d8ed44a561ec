"""Host I/O: FASTQ parsing and the native host library's bindings."""

from .fastq import gather_pack, read_fastq_index, read_fastq_matrix

__all__ = ["gather_pack", "read_fastq_index", "read_fastq_matrix"]
