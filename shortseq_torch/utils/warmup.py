"""One-time CUDA set-up in the background, from
shortseq_tpu/utils/warmup.py.

A process's first use of the card pays once for creating its CUDA
context and for its first device-to-host copy.  Pipelines that will
fetch results from the card call start_transfer_warmup(device) before
their host work (grouping, packing, reading a FASTQ), so that cost
overlaps that work instead of landing on the first launch or fetch.

The thread creates the card's primary context through the CUDA driver
API by ctypes, which releases the interpreter lock for the call: a torch
op that creates it holds the lock throughout, and the caller's host work
would wait for it.  torch then finds the context made.  The thread builds
no kernels (_build keeps its first-use build on the caller's thread) and
is started only for a CUDA device, never at import: a CPU run starts
none.  torch's lazy CUDA initialisation holds a lock, so a caller that
reaches the card while the thread is still in it waits and never
initialises twice.  The thread is non-daemon, as in the JAX package: the
interpreter joins it at exit rather than abandon it inside the CUDA
driver.  Do not start it in a process that will fork workers.
SHORTSEQ_TORCH_NO_WARMUP=1 turns it off.
"""

from __future__ import annotations

import ctypes
import os
import threading

import torch

_lock = threading.Lock()
_thread: threading.Thread | None = None


def _primary_context(index: int) -> bool:
    """Create (retain) card `index`'s primary context through the driver
    API; False when there is no driver or a call fails."""
    try:
        driver = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return False
    driver.cuInit.argtypes = [ctypes.c_uint]
    driver.cuDeviceGet.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    driver.cuDevicePrimaryCtxRetain.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_int]
    for fn in (driver.cuInit, driver.cuDeviceGet,
               driver.cuDevicePrimaryCtxRetain):
        fn.restype = ctypes.c_int
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    return (driver.cuInit(0) == 0
            and driver.cuDeviceGet(ctypes.byref(dev), index) == 0
            and driver.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev) == 0)


def _warm(device: torch.device) -> None:
    # `device` carries its card index (start_transfer_warmup).  When no
    # context can be made, the caller's own first use of the card raises,
    # where it can be handled.
    if not _primary_context(device.index):
        return
    try:
        # The current card is per thread: this one starts on card 0.
        torch.cuda.set_device(device.index)
        torch.zeros(1, device=device).cpu()
    except Exception:
        pass


def start_transfer_warmup(device="cuda") -> None:
    """Create the CUDA context of `device` and make one tiny
    device-to-host copy in a background thread, once per process.  A bare
    "cuda" is the caller's current card, read on the caller's thread
    (card 0 while the caller has not touched CUDA).  A device that is not
    CUDA starts nothing."""
    global _thread
    device = torch.device(device)
    if device.type != "cuda" or os.environ.get("SHORTSEQ_TORCH_NO_WARMUP") == "1":
        return
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device()
                              if torch.cuda.is_initialized() else 0)
    with _lock:
        if _thread is None:
            _thread = threading.Thread(target=_warm, args=(device,),
                                       name="shortseq-torch-cuda-warmup")
            _thread.start()
