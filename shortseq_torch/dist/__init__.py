"""Multi-rank data parallelism, from shortseq_tpu/dist/.

The reference is single-process.  Here FASTQ byte-range shards go to
ranks (torch.distributed, one process per GPU: NCCL between cards, gloo
on the CPU), each rank counts its shards on its device, and the per-rank
count tables merge exactly by hash-bucket exchange (K10, csrc/dist.cu,
then all_to_all_single) or by all_gather + one more unique_count.

Not ported yet: neighbors_sharded_step and `mesh=` on the UMI dedup.
"""

from .count import (ShardedCountTable, count_sharded, count_sharded_auto,
                    count_sharded_bucketed, make_sharded_counter)
from .mesh import DataMesh, data_mesh, initialize_distributed
from .pipeline import (count_fastq_sharded, read_and_count_fastq_distributed,
                       table_to_counter, table_to_host_rows)
from .table import DistributedCountTable, distributed_count_table

__all__ = [
    "DataMesh", "data_mesh", "initialize_distributed",
    "ShardedCountTable", "count_sharded", "count_sharded_auto",
    "count_sharded_bucketed", "make_sharded_counter",
    "count_fastq_sharded", "read_and_count_fastq_distributed",
    "table_to_counter", "table_to_host_rows",
    "DistributedCountTable", "distributed_count_table",
]
