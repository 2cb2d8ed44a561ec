"""Debug helpers: binary dumps of packed words, from
shortseq_tpu/utils/debug.py.

Render packed lanes or blocks as grouped binary so bit-layout bugs are
visible at a glance (the reference's printbin, util.pxd:73-85)."""

from __future__ import annotations

import numpy as np
import torch


def printbin(value: int, bits: int = 64, group: int = 2) -> str:
    """One word as binary, LSB-first groups of `group` bits (2 bits = one
    nucleotide), matching how the packing actually fills the word."""
    raw = format(value & ((1 << bits) - 1), f"0{bits}b")[::-1]
    chunks = [raw[i:i + group] for i in range(0, bits, group)]
    return " ".join(c[::-1] for c in chunks)


def dump_lanes(words, lengths=None, max_rows: int = 8) -> str:
    """Render a `[N, W]` lane matrix row by row; each lane shown as 16
    nucleotide codes (2-bit groups, LSB-first).  `words` is a numpy array
    or an int32 tensor on any device, read on the host as uint32 (so a
    negative lane prints as the JAX package's uint32 lane)."""
    if isinstance(words, torch.Tensor):
        words = words.cpu().numpy().view(np.uint32)
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    words = np.asarray(words)
    out = []
    for i, row in enumerate(words[:max_rows]):
        parts = [printbin(int(lane), bits=32) for lane in row]
        suffix = f"  len={int(lengths[i])}" if lengths is not None else ""
        out.append(f"row {i}: " + " | ".join(parts) + suffix)
    if len(words) > max_rows:
        out.append(f"... ({len(words) - max_rows} more rows)")
    return "\n".join(out)
