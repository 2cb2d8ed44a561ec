"""Process-group bring-up and the `data` mesh, from
shortseq_tpu/dist/mesh.py.

One axis is all this domain needs: reads are independent and a read's
lanes live on one device, so the only distributed dimension is `data`.
torch's idiom is one process per GPU, so the JAX package's 1-D mesh of
devices becomes the ranks of a process group: NCCL between cards, gloo
on the CPU.  A process with no group is a mesh of one rank, over which
every collective of dist/ is the identity.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import _build


class DataMesh(NamedTuple):
    """The ranks of `group` (None: the default group, or this process
    alone when there is none) on which dist/ runs, and the device whose
    tensors this rank hands to the collectives."""

    group: object
    rank: int
    size: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        """True when collectives run through a process group."""
        return dist.is_available() and dist.is_initialized()


def _local_device(device) -> torch.device:
    """`device` resolved for this rank: a bare "cuda" names the card of
    LOCAL_RANK (or the current card), which becomes the current card."""
    device = _build.resolve_device(device)
    if device.type == "cuda" and device.index is None:
        index = os.environ.get("LOCAL_RANK")
        device = torch.device(
            "cuda", int(index) if index is not None
            else torch.cuda.current_device())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def initialize_distributed(init_method: str | None = None,
                           rank: int | None = None,
                           world_size: int | None = None, device="cuda",
                           timeout: float | None = None) -> None:
    """Start the default process group (torch.distributed).

    Runs when the caller names any of init_method / rank / world_size, or
    when the torchrun environment is present (RANK and WORLD_SIZE, with
    MASTER_ADDR / MASTER_PORT for the default env:// rendezvous); with
    neither it is a no-op, so single-process runs stay ungrouped.  Safe to
    call twice: an initialized group is left alone.

    device="cuda" (the default) takes NCCL on the card of LOCAL_RANK,
    made the current card first, and raises without a card; device="cpu"
    takes gloo.  An NCCL failure raises: nothing falls back to gloo.
    timeout (seconds) bounds every collective of the group."""
    explicit = any(v is not None for v in (init_method, rank, world_size))
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if not (explicit or from_env) or dist.is_initialized():
        return
    device = _local_device(device)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timedelta(seconds=timeout)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method or "env://",
        rank=int(os.environ["RANK"]) if rank is None else rank,
        world_size=(int(os.environ["WORLD_SIZE"]) if world_size is None
                    else world_size), **kwargs)


def data_mesh(group=None, device="cuda") -> DataMesh:
    """The 1-D `data` mesh: the ranks of `group` (default: the default
    group; this process alone when no group exists), with this rank's
    device ("cuda" resolves to the current card and raises without one;
    "cpu" for gloo)."""
    device = _local_device(device)
    if dist.is_available() and dist.is_initialized():
        return DataMesh(group, dist.get_rank(group),
                        dist.get_world_size(group), device)
    return DataMesh(None, 0, 1, device)
