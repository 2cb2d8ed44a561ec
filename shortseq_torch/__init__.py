"""shortseq_torch: the PyTorch + CUDA port of shortseq_tpu.

This slice covers UMI read deduplication end to end: FASTQ ingest, host
grouping, and pack + validate, all-pairs hamming and neighbour extraction
as hand-written Hopper kernels (shortseq_torch/csrc/kernels.cu).  The
kernels build at first use on a CUDA tensor; importing the package builds
and initialises nothing.  The port imports neither jax nor shortseq_tpu.
"""

from .umi.dedup import dedup_reads, dedup_umis

__version__ = "0.1.0"

__all__ = ["__version__", "dedup_reads", "dedup_umis"]
