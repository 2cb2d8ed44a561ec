"""shortseq_torch: the PyTorch + CUDA port of shortseq_tpu.

Four slices so far, each end to end on the card:
  * exact FASTQ dedup: `read_and_count_fastq(_table)` with the host or the
    device engine, the lazy `CountTable`, `ShortSeqCounter`, and the
    ShortSeq objects (`pack`, `from_str`, ...); the device engine sorts
    with kernel S (csrc/sort.cu) and groups with kernel D (csrc/count.cu);
  * its sharded and distributed form (`shortseq_torch.dist`): the
    checkpointed byte-range pipeline `count_fastq_sharded`
    (`config.PipelineConfig`), and the torch.distributed merge
    `read_and_count_fastq_distributed` through the bucketed exchange's
    kernel K10 (csrc/dist.cu);
  * UMI read deduplication (`dedup_reads`, `dedup_umis`, and
    `dedup_fastq` from a FASTQ file, the CLI's path) through kernels A, H
    (csrc/umi.cu), B and C (csrc/kernels.cu), `umi_adjacency` and the UMI
    objects;
  * the batch API: `PackedBatch` / `pack_batch` (pack, decode, trim,
    hamming, pairwise, counts, objects) through kernels A, E, F and G
    (csrc/batch.cu) and the calibrated pairwise selector.

Kernels build at first use on a CUDA tensor, and the object extension at
first use of an object name; importing the package builds and
initialises nothing.  The port imports neither jax nor shortseq_tpu.
"""

from .api import (ShortSeqCounter, get_domain_64, get_domain_192,
                  get_domain_var, read_and_count_fastq,
                  read_and_count_fastq_table)
from .batch import PackedBatch, pack_batch
from .count import CountTable
from .umi import (UMI, UMI3p, UMI5p, UMIboth, UMIFactory, dedup_fastq,
                  dedup_reads, dedup_umis, umi_adjacency)

MIN_VAR_NT, MAX_VAR_NT = get_domain_var()
MIN_192_NT, MAX_192_NT = get_domain_192()
MIN_64_NT, MAX_64_NT = get_domain_64()

_LAZY = ("pack", "from_str", "from_bytes", "empty", "ShortSeq64",
         "ShortSeq192", "ShortSeqVar", "BACKEND")


def __getattr__(name):
    # The object backend (native extension or pure Python) is resolved by
    # shortseq_torch.api at first use, not at import.
    if name in _LAZY:
        from . import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    "pack", "from_str", "from_bytes", "empty",
    "ShortSeq64", "ShortSeq192", "ShortSeqVar",
    "ShortSeqCounter", "read_and_count_fastq",
    "read_and_count_fastq_table", "CountTable",
    "MIN_64_NT", "MAX_64_NT", "MIN_192_NT", "MAX_192_NT",
    "MIN_VAR_NT", "MAX_VAR_NT", "BACKEND",
    "PackedBatch", "pack_batch",
    "dedup_fastq", "dedup_reads", "dedup_umis", "umi_adjacency",
    "UMI", "UMI5p", "UMI3p", "UMIboth", "UMIFactory", "__version__",
]
