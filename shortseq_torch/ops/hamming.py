"""Hamming distance over packed int32 lanes, in plain PyTorch.

Counterpart of shortseq_tpu/ops/hamming.py: per lane c = a ^ b, collapse
each 2-bit field with ((c >> 1) | c) & 0x55555555 (complementary codes XOR
to 0b11 and count once), popcount, sum over the lanes.  `hamming_pairwise`
is the plain version of kernel B (ops/pairwise.py).
"""

from __future__ import annotations

import torch

from .lanes import popcount32, srl


def collapse_xor(c: torch.Tensor) -> torch.Tensor:
    """((c >> 1) | c) & 0x55555555 on int32 lanes (logical shift)."""
    return (srl(c, 1) | c) & 0x55555555


def hamming_pairwise(a_words: torch.Tensor,
                     b_words: torch.Tensor) -> torch.Tensor:
    """All-pairs hamming: `[N, W] x [M, W] -> [N, M]` int32.  Broadcasts
    the XOR, so it holds N * M * W lanes at once."""
    c = collapse_xor(a_words[:, None, :] ^ b_words[None, :, :])
    return popcount32(c).sum(dim=-1, dtype=torch.int32)
