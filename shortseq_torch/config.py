"""Runtime configuration of the pipelines, from shortseq_tpu/config.py.

Domain constants (the 32/96/1024-nt width classes, count/ingest.py
WIDTH_EDGES) are NOT configurable: they are part of the bit-exact parity
contract (constants.py).  The JAX package's min_batch_pad is not carried
over: it padded batch row counts for XLA's compile cache, and the port
compiles nothing per shape.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PipelineConfig:
    """Knobs for the FASTQ -> pack -> count pipelines."""

    # Most reads per device batch in the sharded pipeline
    # (dist/pipeline.py): device memory stays O(batch), not O(shard).
    # Batches are not padded.
    batch_size: int = 1 << 18

    # Directory for count-table checkpoints (None disables spilling).
    checkpoint_dir: str | None = None


DEFAULT_CONFIG = PipelineConfig()
