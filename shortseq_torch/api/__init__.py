"""Public object API.  Prefers the native C++ extension (built at first use
from csrc/shortseq_native.cpp - physically 32/48/64-288-byte objects with
C-speed dunders); falls back to the pure-Python implementation with
identical semantics.  Force the fallback with SHORTSEQ_TORCH_FORCE_PYTHON=1.

The backend is resolved at first use of one of its names (module
__getattr__), never at import: importing the package builds nothing."""

from .counter import (ShortSeqCounter, read_and_count_fastq,
                      read_and_count_fastq_table)
from .seq import get_domain_64, get_domain_192, get_domain_var

_BACKEND_NAMES = ("ShortSeq64", "ShortSeq192", "ShortSeqVar", "pack",
                  "from_str", "from_bytes", "from_blocks", "empty")


def _bind() -> None:
    from .. import _build
    from . import seq

    native = _build.load_objects()
    source = seq if native is None else native
    for name in _BACKEND_NAMES:
        globals()[name] = getattr(source, name)
    globals()["BACKEND"] = "python" if native is None else "native"


def __getattr__(name):
    if name in _BACKEND_NAMES or name == "BACKEND":
        _bind()
        return globals()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [*_BACKEND_NAMES, "BACKEND", "ShortSeqCounter",
           "get_domain_64", "get_domain_192", "get_domain_var",
           "read_and_count_fastq", "read_and_count_fastq_table"]
