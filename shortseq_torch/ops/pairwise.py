"""All-pairs hamming through kernel B.

Counterpart of shortseq_tpu/ops/pallas_kernels.py: `hamming_pairwise_tiled`
is the wrapper of the CUDA kernel that replaces the Pallas `_pairwise_tiled`
(shortseq_torch/csrc/kernels.cu, note B), and `pairwise_hamming` stands
where `pairwise_hamming_auto` stood.  There is no calibration and no
fallback: a CUDA tensor always goes to kernel B, a CPU tensor always to the
plain version (ops/hamming.py), and the launch count on the wrapper shows
which ran.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .hamming import hamming_pairwise
from .lanes import from_numpy_u32

# The grid's y dimension (65535 blocks) times the 64-row tile.
_MAX_ROWS = 65535 * 64


def hamming_pairwise_tiled(a: torch.Tensor, b: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """`[N, W] x [M, W]` int32 lanes -> `[N, M]` int32 distances (kernel
    B).  `out`, when given, is a contiguous `[N, M]` int32 tensor that
    receives the result (the UMI stage reuses one slab for every block)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"pairwise operands must be [N, W] and [M, W], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    n, w = a.shape
    m = b.shape[0]
    if out is not None and (tuple(out.shape) != (n, m)
                            or out.dtype != torch.int32):
        raise ValueError(f"out must be a [{n}, {m}] int32 tensor, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if a.device.type == "cpu":
        dist = hamming_pairwise(a, b)
        return dist if out is None else out.copy_(dist)
    _build.check_operand(a, "a", torch.int32, 2, a.device)
    _build.check_operand(b, "b", torch.int32, 2, a.device)
    if n > _MAX_ROWS:
        raise ValueError(f"pairwise kernel takes at most {_MAX_ROWS} rows "
                         f"of a per call, got {n}")
    if out is None:
        out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    else:
        _build.check_operand(out, "out", torch.int32, 2, a.device)
    _build.launch("ssq_pairwise_hamming", a.data_ptr(), b.data_ptr(),
                  out.data_ptr(), n, m, w)
    hamming_pairwise_tiled.launches += 1
    return out


hamming_pairwise_tiled.launches = 0


def pairwise_hamming(a, b) -> torch.Tensor:
    """All-pairs hamming of packed words given as tensors or as numpy
    uint32 arrays (these go to the CPU): the port's pairwise entry."""
    if isinstance(a, np.ndarray):
        a = from_numpy_u32(a)
    if isinstance(b, np.ndarray):
        b = from_numpy_u32(b)
    return hamming_pairwise_tiled(a, b)
