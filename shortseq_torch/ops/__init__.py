"""Device ops on packed int32 lanes: pack + validate (kernel A), all-pairs
hamming (kernel B), each beside its plain PyTorch version."""

from .bitpack import (pack_and_validate_plain, pack_and_validate_rows,
                      pack_and_validate_u32)
from .hamming import collapse_xor, hamming_pairwise
from .lanes import from_numpy_u32, popcount32, srl, to_numpy_u32
from .pairwise import hamming_pairwise_tiled, pairwise_hamming

__all__ = [
    "collapse_xor", "from_numpy_u32", "hamming_pairwise",
    "hamming_pairwise_tiled", "pack_and_validate_plain",
    "pack_and_validate_rows", "pack_and_validate_u32", "pairwise_hamming",
    "popcount32", "srl", "to_numpy_u32",
]
