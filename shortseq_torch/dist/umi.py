"""Sharded UMI adjacency, from shortseq_tpu/dist/umi.py.

The O(U^2) pairwise neighbour search is the only super-linear stage of
UMI clustering, and it is data-parallel over ROW BANDS.  Every rank holds
all U_pad packed UMIs; rank r takes the contiguous band of real rows
[r * B, min((r + 1) * B, U)), B = U_pad / size, and runs kernel H
(umi/dedup.neighbor_lists_fused) on it against all U_pad columns on its
device: only [band, k] indices and [band] counts come out of it.  The
bands are gathered in rank order (dist/pipeline.gather_row_sharded: an
all_gather of the card's tensors, then one copy to the host), so every
rank ends with the same (idx, cnt) in global row order.  Graph collapse
stays on the host: it is O(edges), not O(U^2).
"""

from __future__ import annotations

import torch


def _check_same_problem(mesh, u: int, u_pad: int, w: int, threshold: int,
                        k: int) -> None:
    """Raise on every rank unless all ranks hold the same problem (rows,
    padded rows, lanes, threshold, k): the bands and the gather need it,
    and a mismatch would otherwise hang a collective."""
    from .count import _all_gather

    mine = torch.tensor([[u, u_pad, w, threshold, k]], dtype=torch.int64,
                        device=mesh.device)
    every = _all_gather(mesh, mine)
    if not bool((every == every[0]).all()):
        raise ValueError(
            "ranks disagree on the UMI problem (rows, padded rows, lanes, "
            f"threshold, k): {every.tolist()}")


def neighbors_sharded_step(mesh, threshold: int, k: int, block: int):
    """The sharded neighbour pass over `mesh` (a dist.DataMesh): returns a
    callable (words [U_pad, W] int32, lengths [U_pad] int32, gids [U_pad]
    int32, u) -> (idx [u, k] int32, cnt [u] int32) host arrays in global
    row order, the same on every rank, with idx's empty slots U_pad.
    Every rank calls it together with the same operands, on mesh.device;
    rows at and past `u` are pad rows, matched against but not computed.
    U_pad must be a multiple of mesh.size * block, as in the JAX package.
    With
    no process group the step is the single-device pass; over a group of
    one rank the collectives run and are the identity."""
    from ..umi.dedup import neighbor_lists_fused
    from .pipeline import gather_row_sharded

    def step(words, lengths, gids, u):
        u_pad, w = words.shape
        if not 0 <= u <= u_pad or u_pad % (mesh.size * block):
            raise ValueError(
                f"{u} real rows of {u_pad}: the padded rows must be a "
                f"multiple of {mesh.size} ranks x block {block}")
        if mesh.distributed:
            _check_same_problem(mesh, u, u_pad, w, threshold, k)
        band = u_pad // mesh.size
        lo = min(mesh.rank * band, u)
        hi = min(lo + band, u)
        rows = torch.arange(lo, hi, dtype=torch.int32, device=mesh.device)
        idx, cnt = neighbor_lists_fused(
            words[lo:hi], lengths[lo:hi], gids[lo:hi], rows, words, lengths,
            gids, threshold, k)
        # One gather of both: the counts ride as a last column.
        both = gather_row_sharded(torch.cat([idx, cnt[:, None]], 1), mesh)
        return both[:, :k], both[:, k]

    return step
