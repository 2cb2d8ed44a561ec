"""Pure-Python bit-exact model of the reference packing semantics (the
port's copy of shortseq_tpu/oracle.py).

This module is the single source of truth for *scalar* (one sequence at a
time) semantics: the Python object layer (api/seq.py) calls into it when the
native extension is unavailable, and every device op is tested against it.

Bit-level behavior mirrors the reference (cited per function); everything
operates on Python ints representing the reference's little-endian uint64
blocks: nucleotide i lives in block i // 32 at bit offset 2 * (i % 32).
"""

from __future__ import annotations

from typing import List, Sequence

from .constants import (
    BLOOM,
    CHARMAP,
    LENGTH_MISMATCH_MSG,
    NT_PER_BLOCK,
    UNSUPPORTED_BASE_MSG,
    blocks_for_length,
)

_MASK64 = (1 << 64) - 1
_EVEN_BITS = 0x5555555555555555


def is_base(byte: int) -> bool:
    """Bloom-filter validity check for one ASCII byte
    (reference util.pxd:98-99; passes only uppercase A/C/G/T among
    printable ASCII)."""
    return BLOOM & (1 << (byte & 63)) == 0


def first_invalid_char(seq) -> str | None:
    """First byte of `seq` (bytes / uint8 iterable) failing the bloom
    filter, as a 1-char str for the reference's error message - or None.
    Shared by every batched path that must convert a device validity mask
    back into the reference's per-character exception."""
    for c in seq:
        c = int(c)
        if not is_base(c):
            return chr(c)
    return None


def encode_bytes(seq: bytes) -> List[int]:
    """Pack ASCII bytes into a list of 64-bit blocks, LSB-first.

    Bit-exact with the reference marshalling pipeline
    (util.pyx:78-140, short_seq_64.pyx:96-108): 2-bit code per base via
    (ascii >> 1) & 3, base i at block i//32 bits 2*(i%32), tail block
    zero-padded.  Raises on any byte that fails the bloom filter, with the
    reference's message (short_seq_64.pyx:105).
    """
    n_blocks = blocks_for_length(len(seq))
    blocks = [0] * max(n_blocks, 1) if seq else [0]
    for i, byte in enumerate(seq):
        if not is_base(byte):
            raise Exception(f"{UNSUPPORTED_BASE_MSG}: {chr(byte)}")
        code = (byte >> 1) & 3
        blocks[i // NT_PER_BLOCK] |= code << (2 * (i % NT_PER_BLOCK))
    return blocks[:n_blocks] if seq else [0]


def decode_blocks(blocks: Sequence[int], length: int) -> str:
    """Decode packed blocks back to the original string
    (reference short_seq_64.pyx:114-121 and friends)."""
    chars = []
    for i in range(length):
        code = (blocks[i // NT_PER_BLOCK] >> (2 * (i % NT_PER_BLOCK))) & 3
        chars.append(CHARMAP[code])
    return "".join(chars)


def hamming_blocks(a: Sequence[int], b: Sequence[int], length: int) -> int:
    """XOR + collapse + popcount hamming distance over packed blocks
    (reference short_seq_64.pyx:77-84: complementary codes XOR to 0b11,
    which must count once, hence ((c >> 1) | c) & 0x5555...)."""
    total = 0
    for i in range(blocks_for_length(length)):
        c = (a[i] ^ b[i]) & _MASK64
        c = ((c >> 1) | c) & _EVEN_BITS
        total += bin(c).count("1")
    return total


def slice_blocks(src: Sequence[int], start: int, length: int) -> List[int]:
    """Extract `length` nts starting at nt `start` as fresh packed blocks.

    Semantics of the reference's _slice / _shift_copy_trim
    (short_seq.pyx:94-238) including the final-block trim, but without its
    one-past-the-end read (src[i+1] is only consulted when it exists).
    """
    if length == 0:
        return [0]
    block_idx, nt_off = divmod(start, NT_PER_BLOCK)
    offset = nt_off * 2
    n_out = blocks_for_length(length)
    out = []
    for i in range(n_out):
        lo = src[block_idx + i] >> offset if block_idx + i < len(src) else 0
        hi = 0
        if offset and block_idx + i + 1 < len(src):
            hi = (src[block_idx + i + 1] << (64 - offset)) & _MASK64
        out.append((lo | hi) & _MASK64)
    tail = (length * 2) % 64
    if tail:
        out[-1] &= (1 << tail) - 1
    return out


def subscript_block(src: Sequence[int], index: int) -> int:
    """Single-base extraction -> 2-bit code (reference short_seq.pyx:78-91)."""
    block_idx, nt_off = divmod(index, NT_PER_BLOCK)
    return (src[block_idx] >> (nt_off * 2)) & 3


def blocks_to_lanes(blocks: Sequence[int], n_lanes: int) -> List[int]:
    """Reference uint64 blocks -> little-endian uint32 lane list (the
    packed-word layout of every device table)."""
    lanes = []
    for b in blocks:
        lanes.append(b & 0xFFFFFFFF)
        lanes.append((b >> 32) & 0xFFFFFFFF)
    lanes.extend([0] * (n_lanes - len(lanes)))
    return lanes[:n_lanes]


def lanes_to_blocks(lanes: Sequence[int], n_blocks: int) -> List[int]:
    """Inverse of blocks_to_lanes."""
    return [
        (lanes[2 * i] & 0xFFFFFFFF) | ((lanes[2 * i + 1] & 0xFFFFFFFF) << 32)
        for i in range(n_blocks)
    ]


def check_same_length(len_a: int, len_b: int) -> None:
    if len_a != len_b:
        raise Exception(f"{LENGTH_MISMATCH_MSG} ({len_a} != {len_b})")


def str_hamming(a: str, b: str) -> int:
    """The test oracle the reference uses (unit_tests_main.py:160)."""
    return sum(x != y for x, y in zip(a, b))

