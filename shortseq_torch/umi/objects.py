"""UMI object layer, from shortseq_tpu/umi/objects.py (host only).

Parity surface for the reference's alpha UMI classes (reference
umi/umi.pyx:6-59): a UMI-tagged read holds the insert sequence plus up to
two UMIs clipped from the 5' and/or 3' ends, each a ShortSeq object, which
gives the reference's equality semantics (length + UMI fields +
sequence).  Decode works and lengths come from the actual byte count (the
reference's unfinished decoder is treated as intent, not oracle).

The ShortSeq backend (native extension or pure Python) is looked up at
first use, never at import: importing this module builds nothing.
"""

from __future__ import annotations

from .dedup import split_read


def _api():
    """shortseq_torch.api, whose object backend binds at first use."""
    from .. import api

    return api


class UMI:
    """Base: an insert sequence with no UMIs (reference umi/umi.pyx:6-14)."""

    __slots__ = ("seq",)

    def __init__(self, seq=None):
        self.seq = seq if seq is not None else _api().empty

    def __hash__(self):
        # First word of the packed insert, like the reference (umi.pyx:8).
        return hash(self.seq)

    def _key(self):
        return (type(self).__name__, len(self.seq), self.seq)

    def __eq__(self, other):
        return type(other) is type(self) and self._key() == other._key()

    def __len__(self):
        return len(self.seq)

    def __repr__(self):
        return f"<{type(self).__name__} seq={self.seq!s}>"


class UMI5p(UMI):
    """Insert + 5'-end UMI (reference umi/umi.pyx:16-22)."""

    __slots__ = ("umi5",)

    def __init__(self, seq=None, umi5=None):
        super().__init__(seq)
        self.umi5 = umi5 if umi5 is not None else _api().empty

    def _key(self):
        return super()._key() + (len(self.umi5), self.umi5)

    def __repr__(self):
        return f"<UMI5p umi5={self.umi5!s} seq={self.seq!s}>"


class UMI3p(UMI):
    """Insert + 3'-end UMI (reference umi/umi.pyx:24-29)."""

    __slots__ = ("umi3",)

    def __init__(self, seq=None, umi3=None):
        super().__init__(seq)
        self.umi3 = umi3 if umi3 is not None else _api().empty

    def _key(self):
        return super()._key() + (len(self.umi3), self.umi3)

    def __repr__(self):
        return f"<UMI3p umi3={self.umi3!s} seq={self.seq!s}>"


class UMIboth(UMI):
    """Insert + UMIs on both ends (reference umi/umi.pyx:31-35)."""

    __slots__ = ("umi5", "umi3")

    def __init__(self, seq=None, umi5=None, umi3=None):
        super().__init__(seq)
        self.umi5 = umi5 if umi5 is not None else _api().empty
        self.umi3 = umi3 if umi3 is not None else _api().empty

    def _key(self):
        return super()._key() + (len(self.umi5), self.umi5,
                                 len(self.umi3), self.umi3)

    def __repr__(self):
        return (f"<UMIboth umi5={self.umi5!s} umi3={self.umi3!s} "
                f"seq={self.seq!s}>")


class UMIFactory:
    """Splits reads into (5' UMI, insert, 3' UMI) and builds the matching
    UMI class (reference umi/umi.pyx:38-59's function-pointer dispatch,
    done here with a plain class selection)."""

    __slots__ = ("len_5p", "len_3p", "_cls")

    def __init__(self, len_5p: int = 0, len_3p: int = 0):
        if len_5p < 0 or len_3p < 0:
            raise ValueError("UMI lengths must be non-negative")
        if len_5p > 32 or len_3p > 32:
            # One packed word per UMI, like the reference's uint32 pair
            # (umi/umi.pxd:57-70; 16 nt there - 32 here, one full word).
            raise ValueError("UMI lengths above 32 nt are not supported")
        self.len_5p = len_5p
        self.len_3p = len_3p
        if len_5p and len_3p:
            self._cls = UMIboth
        elif len_5p:
            self._cls = UMI5p
        elif len_3p:
            self._cls = UMI3p
        else:
            self._cls = UMI

    def from_bytes(self, seq_bytes: bytes):
        from_bytes = _api().from_bytes
        umi5, insert, umi3 = split_read(seq_bytes, self.len_5p, self.len_3p)
        cls = self._cls
        if cls is UMI:
            return UMI(from_bytes(insert))
        if cls is UMI5p:
            return UMI5p(from_bytes(insert), from_bytes(umi5))
        if cls is UMI3p:
            return UMI3p(from_bytes(insert), umi3=from_bytes(umi3))
        return UMIboth(from_bytes(insert), from_bytes(umi5), from_bytes(umi3))

    def from_str(self, seq_str: str):
        return self.from_bytes(seq_str.encode("ascii"))

    def from_iter(self, reads):
        """Batch construction from an iterable of bytes."""
        return [self.from_bytes(r) for r in reads]
