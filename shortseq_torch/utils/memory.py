"""Deep object-size measurement (pympler.asizeof substitute), from
shortseq_tpu/utils/memory.py.

The reference's memory benchmark measures *deep* size via pympler.asizeof
(reference tests/benchmark.py:44-79) - the full transitive footprint of an
object, not just its header.  This is a small faithful equivalent:
recursive traversal over gc.get_referents with an identity memo, summing
sys.getsizeof at every node.  For the object classes the benchmark
compares it is exact:

* ShortSeq64/192 - __sizeof__ covers the whole inline object (32/48 B);
  no referents.
* ShortSeqVar - __sizeof__ includes the heap block array
  (csrc/shortseq_native.cpp SSVar_sizeof); no referents.
* str / bytes - __sizeof__ covers header + payload; no referents.
* numpy arrays - ndarray.__sizeof__ includes the data buffer for owning
  arrays; views add their base through get_referents.

Shared referents are counted once per call (identity memo), matching
asizeof's default accounting.
"""

from __future__ import annotations

import gc
import sys
import types

# Referents that drag in interpreter-wide state rather than the object's
# own footprint: types and modules obviously, but also functions/methods
# (gc.get_referents of a function includes its __globals__ - a plain
# dict, invisible to a module check - so following one callback would sum
# the whole defining module's namespace), frames, and code objects.
# pympler.asizeof treats these as atomic by default too.
_ATOMIC = (type, types.ModuleType, types.FunctionType,
           types.BuiltinFunctionType, types.MethodType, types.FrameType,
           types.CodeType)


def deep_sizeof(*objs) -> int:
    """Total deep size in bytes of the given objects (shared substructure
    counted once across the whole call)."""
    seen: set[int] = set()
    total = 0
    stack = list(objs)
    while stack:
        obj = stack.pop()
        oid = id(obj)
        if oid in seen:
            continue
        seen.add(oid)
        try:
            total += sys.getsizeof(obj)
        except TypeError:
            continue
        for ref in gc.get_referents(obj):
            if isinstance(ref, _ATOMIC):
                continue
            stack.append(ref)
    return total
