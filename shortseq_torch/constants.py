"""Domain constants of the port, copied from shortseq_tpu/constants.py
(pure Python, so the port carries its own copy rather than importing the
JAX package).  See that file for the full reasoning behind each value.

One reference 64-bit block is a little-endian pair of 32-bit lanes:
nucleotide i of a read lives in lane i // 16 at bits 2 * (i % 16), so
reference block b is lanes[2b] | lanes[2b + 1] << 32.
"""

# Width-class domains (reference short_seq_64.pyx:27-28 and friends).
MIN_64_NT = 0
MAX_64_NT = 32
MIN_192_NT = 33
MAX_192_NT = 96
MIN_VAR_NT = 97
MAX_VAR_NT = 1024
MAX_REPR_LEN = 75

NT_PER_BLOCK = 32          # nts per reference uint64 block
NT_PER_LANE = 16           # nts per 32-bit lane
LANES_PER_BLOCK = 2

# Lane and block counts per width bucket.
LANES_64 = 2               # 1 block
LANES_192 = 6              # 3 blocks
LANES_VAR = 64             # 32 blocks = 1024 nt

BLOCKS_64 = 1
BLOCKS_192 = 3
BLOCKS_VAR = 32

# code = (ascii >> 1) & 3: A=00, C=01, T=10, G=11; code -> char.
CODE_A, CODE_C, CODE_T, CODE_G = 0, 1, 2, 3
CHARMAP = ("A", "C", "T", "G")
CHARMAP_BYTES = (65, 67, 84, 71)               # ord() of the above

# 64-bit bloom filter; bit (char & 63) SET means the char is rejected.
# A byte passes iff (c & 63) is one of {1, 3, 7, 20}: uppercase A/C/G/T
# among printable ASCII, plus the reference's false-pass aliases, which
# every path here accepts on purpose (byte-for-byte reference parity).
BLOOM = 0xFFFFFFFFFFEFFF75
VALID_BYTES = frozenset(b"ACGT")

# Padding byte of in-repo ASCII matrices: passes the bloom and encodes to
# code 0, so the pack may skip per-byte length masking (pad_valid=True).
PAD_BYTE = 0x01

UNSUPPORTED_BASE_MSG = "Unsupported base character"
TOO_LONG_MSG = f"Sequences longer than {MAX_VAR_NT} bases are not supported."
LENGTH_MISMATCH_MSG = "Hamming distance requires sequences of equal length"


def lanes_for_length(length: int) -> int:
    """Number of 32-bit lanes needed for `length` nucleotides."""
    return -(-length // NT_PER_LANE)


def blocks_for_length(length: int) -> int:
    """Number of reference 64-bit blocks for `length` nucleotides."""
    return -(-length // NT_PER_BLOCK)


def bucket_lanes(length: int) -> int:
    """Lane count of the width bucket a read of `length` nts belongs to."""
    if length <= MAX_64_NT:
        return LANES_64
    if length <= MAX_192_NT:
        return LANES_192
    if length <= MAX_VAR_NT:
        return LANES_VAR
    raise ValueError(TOO_LONG_MSG)
