"""Device ops on packed int32 lanes: pack + validate and pack only (kernel
A), unpack (kernel E), row hamming (kernel G), all-pairs hamming (kernel
B, the one-hot product, and the calibrated selector), each beside its
plain PyTorch version.  Names follow shortseq_tpu.ops.  The row-folded
names (`fold_for`, `pack_folded`, `pack_and_validate_folded`) keep the
JAX signatures and run kernel A on the unfolded view of their batch, and
`hamming_pairwise_mxu` is the one-hot product `hamming_pairwise_onehot`."""

from .bitpack import (collapse_xor, first_bad_byte, first_bad_byte_u32,
                      fold_for, pack_and_validate, pack_and_validate_folded,
                      pack_and_validate_plain, pack_and_validate_rows,
                      pack_and_validate_u32, pack_folded, pack_rows,
                      pack_words, pack_words_plain, pack_words_u32,
                      unpack_ascii, unpack_ascii_plain, validate,
                      validate_u32)
from .hamming import (hamming_pairwise, hamming_pairwise_mxu,
                      hamming_pairwise_onehot, hamming_rows,
                      hamming_rows_plain, one_hot_codes)
from .lanes import from_numpy_u32, popcount32, srl, to_numpy_u32
from .pairwise import (calibrate_pairwise, hamming_pairwise_tiled,
                       pairwise_hamming_auto)

__all__ = [
    "calibrate_pairwise", "collapse_xor", "first_bad_byte",
    "first_bad_byte_u32", "fold_for", "from_numpy_u32", "hamming_pairwise",
    "hamming_pairwise_mxu", "hamming_pairwise_onehot",
    "hamming_pairwise_tiled", "hamming_rows", "hamming_rows_plain",
    "one_hot_codes", "pack_and_validate", "pack_and_validate_folded",
    "pack_and_validate_plain", "pack_and_validate_rows",
    "pack_and_validate_u32", "pack_folded", "pack_rows", "pack_words",
    "pack_words_plain", "pack_words_u32", "pairwise_hamming_auto",
    "popcount32", "srl", "to_numpy_u32", "unpack_ascii",
    "unpack_ascii_plain", "validate", "validate_u32",
]
