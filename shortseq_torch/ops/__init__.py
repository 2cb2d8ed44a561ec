"""Device ops on packed int32 lanes: pack + validate and pack only (kernel
A), unpack (kernel E), row hamming (kernel G), all-pairs hamming (kernel
B, the one-hot product, and the calibrated selector), each beside its
plain PyTorch version.  Names follow shortseq_tpu.ops; its row-folding
helpers (`fold_for`, `pack_folded`, `pack_and_validate_folded`) exist
only for the TPU and have no counterpart, and `hamming_pairwise_mxu` is
`hamming_pairwise_onehot` here."""

from .bitpack import (first_bad_byte, first_bad_byte_u32, pack_and_validate,
                      pack_and_validate_plain, pack_and_validate_rows,
                      pack_and_validate_u32, pack_rows, pack_words,
                      pack_words_plain, pack_words_u32, unpack_ascii,
                      unpack_ascii_plain, validate, validate_u32)
from .hamming import (collapse_xor, hamming_pairwise, hamming_pairwise_onehot,
                      hamming_rows, hamming_rows_plain, one_hot_codes)
from .lanes import from_numpy_u32, popcount32, srl, to_numpy_u32
from .pairwise import (calibrate_pairwise, hamming_pairwise_tiled,
                       pairwise_hamming_auto)

__all__ = [
    "calibrate_pairwise", "collapse_xor", "first_bad_byte",
    "first_bad_byte_u32", "from_numpy_u32", "hamming_pairwise",
    "hamming_pairwise_onehot", "hamming_pairwise_tiled", "hamming_rows",
    "hamming_rows_plain", "one_hot_codes", "pack_and_validate",
    "pack_and_validate_plain", "pack_and_validate_rows",
    "pack_and_validate_u32", "pack_rows", "pack_words", "pack_words_plain",
    "pack_words_u32", "pairwise_hamming_auto", "popcount32", "srl",
    "to_numpy_u32", "unpack_ascii", "unpack_ascii_plain", "validate",
    "validate_u32",
]
