"""Hamming distance over packed int32 lanes.

Counterpart of shortseq_tpu/ops/hamming.py: per lane c = a ^ b, collapse
each 2-bit field with ((c >> 1) | c) & 0x55555555 (complementary codes XOR
to 0b11 and count once), popcount, sum over the lanes.

* `hamming_rows`: row-wise, through kernel G (csrc/batch.cu), with
  `hamming_rows_plain` beside it.
* `hamming_pairwise`: all pairs by broadcasting, the plain version of
  kernel B (ops/pairwise.py).
* `hamming_pairwise_onehot` (also named `hamming_pairwise_mxu`, as in the
  JAX package): all pairs as one matrix product of one-hot codes.  The
  JAX package computes it outside any Pallas kernel, so here it is
  `torch.matmul`.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.profiling import scoped
from .bitpack import collapse_xor
from .lanes import popcount32


def hamming_rows_plain(a_words: torch.Tensor,
                       b_words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel G (any device)."""
    return popcount32(collapse_xor(a_words ^ b_words)).sum(
        dim=-1, dtype=torch.int32)


@scoped("ssq.hamming_rows")
def hamming_rows(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """Row-wise hamming: `[N, W] x [N, W] -> [N]` int32 (kernel G).  A CUDA
    tensor launches the kernel once (16-byte loads when both operands
    start on 16 bytes, 4-byte loads for other contiguous views, such as a
    row slice); a CPU tensor takes the plain version."""
    if a_words.dim() != 2 or a_words.shape != b_words.shape:
        raise ValueError(f"row hamming operands must both be [N, W], got "
                         f"{tuple(a_words.shape)} and {tuple(b_words.shape)}")
    if a_words.device.type == "cpu":
        return hamming_rows_plain(a_words, b_words)
    _build.check_operand(a_words, "a", torch.int32, 2, a_words.device)
    _build.check_operand(b_words, "b", torch.int32, 2, a_words.device)
    n, w = a_words.shape
    out = torch.empty(n, dtype=torch.int32, device=a_words.device)
    _build.launch("ssq_hamming_rows", a_words.data_ptr(), b_words.data_ptr(),
                  out.data_ptr(), n, w)
    hamming_rows.launches += 1
    return out


hamming_rows.launches = 0


@scoped("ssq.pairwise_jnp")
def hamming_pairwise(a_words: torch.Tensor,
                     b_words: torch.Tensor) -> torch.Tensor:
    """All-pairs hamming: `[N, W] x [M, W] -> [N, M]` int32.  Broadcasts
    the XOR, so it holds N * M * W lanes at once."""
    c = collapse_xor(a_words[:, None, :] ^ b_words[None, :, :])
    return popcount32(c).sum(dim=-1, dtype=torch.int32)


def _onehot_dtype(words: torch.Tensor) -> torch.dtype:
    """float16 on the card while a pair's match count (at most 16 W) stays
    within 2048, else float32 (exact to 2^24).

    Every partial sum of the product is a whole number no larger than the
    final count, so in float16 (integers exact to 2048) the product is
    exact in any accumulation order, whatever the GEMM accumulates in.
    bfloat16 would not do: it rounds integers above 256, and W = 64 gives
    up to 1024 matches.  The CPU keeps float32."""
    if words.device.type == "cuda" and 16 * words.shape[1] <= 2048:
        return torch.float16
    return torch.float32


def one_hot_codes(words: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`[N, W]` packed lanes -> `[N, 64 W]` one-hot of the 2-bit codes (16
    codes per lane x 4 classes), LSB first as the reference lays bits out.
    Zero padding past a read's length one-hots as code 0 ('A'), exactly as
    the XOR formulation treats it."""
    n, w = words.shape
    shifts = torch.arange(0, 32, 2, dtype=torch.int32, device=words.device)
    codes = (words[:, :, None] >> shifts) & 3
    classes = torch.arange(4, dtype=torch.int32, device=words.device)
    return (codes[..., None] == classes).reshape(n, 64 * w).to(dtype)


@scoped("ssq.pairwise_mxu")
def hamming_pairwise_onehot(a_words: torch.Tensor,
                            b_words: torch.Tensor) -> torch.Tensor:
    """All-pairs hamming as one matrix product: `dist = 16 W - matches`,
    matches = one_hot(a) @ one_hot(b).T, on the tensor cores of the card
    (float16, exact: see _onehot_dtype)."""
    w = a_words.shape[1]
    dtype = _onehot_dtype(a_words)
    matches = one_hot_codes(a_words, dtype) @ one_hot_codes(b_words, dtype).T
    return matches.to(torch.int32).neg_().add_(16 * w)


#: The JAX package's name for the one-hot product (its MXU matmul).
hamming_pairwise_mxu = hamming_pairwise_onehot
