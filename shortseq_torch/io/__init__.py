"""Host I/O: FASTQ parsing and the native host library's bindings."""

from .fastq import (fastq_line_index, gather_pack, read_fastq_index,
                    read_fastq_lines, read_fastq_matrix, read_fastq_seqs)

__all__ = ["fastq_line_index", "gather_pack", "read_fastq_index",
           "read_fastq_lines", "read_fastq_matrix", "read_fastq_seqs"]
