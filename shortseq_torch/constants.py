"""Domain constants of the UMI slice, copied from shortseq_tpu/constants.py
(pure Python, so the port carries its own copy rather than importing the
JAX package).  See that file for the full reasoning behind each value."""

# Longest sequence of the 2-lane (one 64-bit block) width class.
MAX_64_NT = 32

# 64-bit bloom filter; bit (char & 63) SET means the char is rejected.
# A byte passes iff (c & 63) is one of {1, 3, 7, 20}: uppercase A/C/G/T
# among printable ASCII, plus the reference's false-pass aliases.
BLOOM = 0xFFFFFFFFFFEFFF75

# Padding byte of in-repo ASCII matrices: passes the bloom and encodes to
# code 0, so the pack may skip per-byte length masking (pad_valid=True).
PAD_BYTE = 0x01

UNSUPPORTED_BASE_MSG = "Unsupported base character"
