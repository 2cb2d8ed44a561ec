"""Host-side ShortSeq object layer - pure-Python implementation.

API parity with the reference's public surface (reference
shortseq/__init__.py:1-14): `pack`, `from_str`, `from_bytes`,
`ShortSeq64` (0-32 nt), `ShortSeq192` (33-96 nt), `ShortSeqVar`
(97-1024 nt), domain constants, and the `empty` singleton.  Dunder
semantics are bit-exact with the reference, cited per method.

The port's copy of shortseq_tpu/api/seq.py.  This module is the portable
fallback; when the native C++ extension is built (csrc/shortseq_native.cpp,
by shortseq_torch/_build.py) the package exports its types instead, which
also makes the 32/48/64-288 byte object footprints physically real.  Bulk
work (counting millions of reads) goes through the count tables
(shortseq_torch.count) - these objects exist for ergonomic,
reference-compatible scalar access.
"""

from __future__ import annotations

import sys

from .. import oracle
from ..constants import (
    LENGTH_MISMATCH_MSG,
    MAX_64_NT,
    MAX_192_NT,
    MAX_REPR_LEN,
    MAX_VAR_NT,
    MIN_64_NT,
    MIN_192_NT,
    MIN_VAR_NT,
    TOO_LONG_MSG,
    UNSUPPORTED_BASE_MSG,
    blocks_for_length,
)

__all__ = [
    "ShortSeq64", "ShortSeq192", "ShortSeqVar",
    "pack", "from_str", "from_bytes", "empty",
    "get_domain_64", "get_domain_192", "get_domain_var",
]


def _to_hash(block0: int) -> int:
    """Reinterpret the low packed word as a signed 64-bit Py_hash_t, exactly
    as the reference's C cast does (short_seq_64.pyx:35-36).  CPython maps a
    -1 return to -2 on its own, same as the compiled reference."""
    return block0 - (1 << 64) if block0 >= (1 << 63) else block0


# sys.getsizeof(obj) = obj.__sizeof__() + GC-head size for tracked objects.
# The reference's Cython types are untracked, so getsizeof == the C struct
# size (32/48/32+heap).  The pure-Python fallback reports the canonical
# packed-layout size (what the native extension physically allocates) so the
# reference's size assertions (unit_tests_main.py:73-86,493-500) hold on
# either backend.
class _Probe:
    __slots__ = ()


_GC_HEAD = sys.getsizeof(_Probe()) - _Probe().__sizeof__()


def _getitem(blocks, length, item):
    """Shared subscript/slice engine (reference short_seq.pyx:78-238 plus the
    per-class __getitem__ bodies, e.g. short_seq_64.pyx:51-75)."""
    if isinstance(item, slice):
        start, stop, step = item.indices(length)
        if step != 1:
            raise TypeError("Slice step not supported")
        slice_len = max(0, stop - start)
        if slice_len == 0:
            return empty
        if slice_len == 1:
            return _subscript(blocks, start)
        return _slice(blocks, start, slice_len)
    elif isinstance(item, int):
        index = item
        if index < 0:
            index += length
        if index < 0 or index >= length:
            raise IndexError("Sequence index out of range")
        return _subscript(blocks, index)
    else:
        raise TypeError(f"Invalid index type: {type(item)}")


def _subscript(blocks, index):
    out = ShortSeq64.__new__(ShortSeq64)
    out._packed = oracle.subscript_block(blocks, index)
    out._length = 1
    return out


def _slice(blocks, start, slice_len):
    """Narrowest-result-type slicing (reference short_seq.pyx:94-116)."""
    new_blocks = oracle.slice_blocks(blocks, start, slice_len)
    if slice_len <= MAX_64_NT:
        out = ShortSeq64.__new__(ShortSeq64)
        out._packed = new_blocks[0]
        out._length = slice_len
        return out
    elif slice_len <= MAX_192_NT:
        out = ShortSeq192.__new__(ShortSeq192)
        pad = blocks_for_length(MAX_192_NT) - len(new_blocks)
        out._blocks = tuple(new_blocks) + (0,) * pad
        out._length = slice_len
        return out
    else:
        out = ShortSeqVar.__new__(ShortSeqVar)
        out._blocks = tuple(new_blocks)
        out._length = slice_len
        return out


class ShortSeq64:
    """0-32 nt in one 64-bit word (reference short_seq_64.pyx:33-90).

    32-byte object in the native layout: 16 B PyObject head + 8 B packed
    word + length + padding (short_seq_64.pxd:11-14)."""

    __slots__ = ("_packed", "_length")

    def __hash__(self):
        return _to_hash(self._packed)

    def __len__(self):
        return self._length

    def __eq__(self, other):
        if type(other) is ShortSeq64:
            return self._length == other._length and self._packed == other._packed
        elif isinstance(other, (str, bytes)):
            return self._length == len(other) and str(self) == other
        else:
            return False

    def __getitem__(self, item):
        return _getitem((self._packed,), self._length, item)

    def __xor__(self, other):
        if type(other) is not ShortSeq64:
            raise TypeError(
                f"Argument 'other' has incorrect type (expected ShortSeq64, "
                f"got {type(other).__name__})")
        oracle.check_same_length(self._length, other._length)
        return oracle.hamming_blocks((self._packed,), (other._packed,), self._length)

    # Reflected form (e.g. 5 ^ seq): the native extension's nb_xor slot
    # handles both directions with the same TypeError; match it here
    # instead of Python's default unsupported-operand message.
    __rxor__ = __xor__

    def __str__(self):
        return oracle.decode_blocks((self._packed,), self._length)

    def __repr__(self):
        return f"<ShortSeq64 ({self._length} nt): {self}>"

    def __sizeof__(self):
        return 32 - _GC_HEAD


class ShortSeq192:
    """33-96 nt in three 64-bit words (reference short_seq_192.pyx:27-97);
    48-byte object in the native layout (short_seq_192.pxd:11-14)."""

    __slots__ = ("_blocks", "_length")

    def __hash__(self):
        return _to_hash(self._blocks[0])  # block[0] only (short_seq_192.pyx:29)

    def __len__(self):
        return self._length

    def __eq__(self, other):
        if type(other) is ShortSeq192:
            n = blocks_for_length(self._length)
            return (self._length == other._length
                    and self._blocks[:n] == other._blocks[:n])
        elif isinstance(other, (str, bytes)):
            return self._length == len(other) and str(self) == other
        else:
            return False

    def __getitem__(self, item):
        return _getitem(self._blocks, self._length, item)

    def __xor__(self, other):
        if type(other) is not ShortSeq192:
            raise TypeError(
                f"Argument 'other' has incorrect type (expected ShortSeq192, "
                f"got {type(other).__name__})")
        oracle.check_same_length(self._length, other._length)
        return oracle.hamming_blocks(self._blocks, other._blocks, self._length)

    # Reflected form (e.g. 5 ^ seq): the native extension's nb_xor slot
    # handles both directions with the same TypeError; match it here
    # instead of Python's default unsupported-operand message.
    __rxor__ = __xor__

    def __str__(self):
        return oracle.decode_blocks(self._blocks, self._length)

    def __repr__(self):
        return f"<ShortSeq192 ({self._length} nt): {self}>"

    def __sizeof__(self):
        return 48 - _GC_HEAD


class ShortSeqVar:
    """97-1024 nt in a variable-length word array
    (reference short_seq_var.pyx:15-93); 32 B header + 8 B per 32-nt block
    (short_seq_var.pxd:14-17)."""

    __slots__ = ("_blocks", "_length")

    def __hash__(self):
        return _to_hash(self._blocks[0])  # first block deref (short_seq_var.pyx:16)

    def __len__(self):
        return self._length

    def __eq__(self, other):
        if type(other) is ShortSeqVar:
            n = blocks_for_length(self._length)
            return (self._length == other._length
                    and self._blocks[:n] == other._blocks[:n])
        elif isinstance(other, (str, bytes)):
            return self._length == len(other) and str(self) == other
        else:
            return False

    def __getitem__(self, item):
        return _getitem(self._blocks, self._length, item)

    def __xor__(self, other):
        if type(other) is not ShortSeqVar:
            raise TypeError(
                f"Argument 'other' has incorrect type (expected ShortSeqVar, "
                f"got {type(other).__name__})")
        oracle.check_same_length(self._length, other._length)
        return oracle.hamming_blocks(self._blocks, other._blocks, self._length)

    # Reflected form (e.g. 5 ^ seq): the native extension's nb_xor slot
    # handles both directions with the same TypeError; match it here
    # instead of Python's default unsupported-operand message.
    __rxor__ = __xor__

    def __str__(self):
        return oracle.decode_blocks(self._blocks, self._length)

    def __repr__(self):
        # Truncated decode, matching short_seq_var.pyx:86-89
        trunc = oracle.decode_blocks(self._blocks, MAX_REPR_LEN)
        return f"<ShortSeqVar ({self._length} nt): {trunc} ... >"

    def __sizeof__(self):
        return 32 + blocks_for_length(self._length) * 8 - _GC_HEAD


# --- Constructors (reference short_seq.pyx:7-74) ----------------------------

empty = ShortSeq64.__new__(ShortSeq64)
empty._packed = 0
empty._length = 0


def from_blocks(blocks, length: int):
    """Build a ShortSeq directly from reference uint64 blocks (the device
    count tables' native key format, count/device.py counts_to_host) -
    no re-encoding, same width dispatch as _new (short_seq.pyx:54-74).

    Strict and backend-identical: too few blocks raise (zero-filling
    would fabricate 'A' bases), and bits above 2*length in the last
    block are masked (stray garbage would make hash/eq disagree with
    pack() of the same decoded string - hash IS the packed word)."""
    if length == 0:
        return empty
    if length > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)
    need = -(-length // 32)
    if len(blocks) < need:
        raise ValueError(
            f"from_blocks: {len(blocks)} blocks given, {need} needed "
            f"for length {length}")
    blocks = tuple(int(b) & 0xFFFFFFFFFFFFFFFF for b in blocks[:need])
    rem = length % 32
    if rem:
        blocks = blocks[:-1] + (blocks[-1] & ((1 << (2 * rem)) - 1),)
    if length <= MAX_64_NT:
        out = ShortSeq64.__new__(ShortSeq64)
        out._packed = blocks[0]
        out._length = length
        return out
    elif length <= MAX_192_NT:
        out = ShortSeq192.__new__(ShortSeq192)
        out._blocks = blocks + (0,) * (3 - len(blocks))
        out._length = length
        return out
    out = ShortSeqVar.__new__(ShortSeqVar)
    out._blocks = blocks
    out._length = length
    return out


def _new(seq_bytes: bytes):
    length = len(seq_bytes)
    if length == 0:
        return empty
    if length > MAX_VAR_NT:
        raise Exception(TOO_LONG_MSG)
    blocks = oracle.encode_bytes(seq_bytes)
    if length <= MAX_64_NT:
        out = ShortSeq64.__new__(ShortSeq64)
        out._packed = blocks[0]
        out._length = length
        return out
    elif length <= MAX_192_NT:
        out = ShortSeq192.__new__(ShortSeq192)
        out._blocks = tuple(blocks) + (0,) * (3 - len(blocks))
        out._length = length
        return out
    else:
        out = ShortSeqVar.__new__(ShortSeqVar)
        out._blocks = tuple(blocks)
        out._length = length
        return out


def _str_to_bytes(seq_str: str) -> bytes:
    try:
        return seq_str.encode("ascii")
    except UnicodeEncodeError:
        bad = next(c for c in seq_str if ord(c) > 127)
        raise Exception(f"{UNSUPPORTED_BASE_MSG}: {bad}") from None


def pack(seq):
    """Type-dispatched constructor (reference short_seq.pyx:14-28)."""
    if isinstance(seq, str):
        if not seq:
            return empty
        return _new(_str_to_bytes(seq))
    elif isinstance(seq, bytes):
        if not seq:
            return empty
        return _new(seq)
    elif type(seq) is ShortSeq64 or type(seq) is ShortSeq192 or type(seq) is ShortSeqVar:
        return seq
    else:
        raise TypeError(f'Cannot pack objects of type "{type(seq)}"')


def from_str(seq_str: str):
    if not seq_str:
        return empty
    return _new(_str_to_bytes(seq_str))


def from_bytes(seq_bytes: bytes):
    if not seq_bytes:
        return empty
    return _new(seq_bytes)


def get_domain_64():
    return MIN_64_NT, MAX_64_NT


def get_domain_192():
    return MIN_192_NT, MAX_192_NT


def get_domain_var():
    return MIN_VAR_NT, MAX_VAR_NT
