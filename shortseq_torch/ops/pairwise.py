"""All-pairs hamming: kernel B and the calibrated selector.

Counterpart of shortseq_tpu/ops/pallas_kernels.py.  `hamming_pairwise_tiled`
is the wrapper of the CUDA kernel that replaces the Pallas `_pairwise_tiled`
(shortseq_torch/csrc/kernels.cu, note B).  `pairwise_hamming_auto` picks
the fastest exact formulation for the device and lane width from a
one-time measurement (`calibrate_pairwise`), cached in memory and on disk:

* on a CUDA tensor: `tiled` (kernel B) or `onehot` (a float16 one-hot
  matrix product on the tensor cores, ops/hamming.py).  The broadcast
  plain version is never a candidate on the card, so calibration is no
  way to it;
* on a CPU tensor: `plain` (the broadcast, ops/hamming.py) or `onehot`.

SHORTSEQ_TORCH_PAIRWISE=tiled|onehot|plain pins the choice (`plain` on a
CUDA tensor raises).  There is no fallback: each call counts the path it
took in `pairwise_hamming_auto.paths`, and kernel B its launches, and
`LAST_PAIRWISE_PATH` names the last call's path.  The JAX package's names
for them: `pallas` is `tiled` (kernel B), `mxu` is `onehot`, `jnp` is
`plain`; its `jnp-fallback` has no counterpart.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import time

import numpy as np
import torch

from .. import _build
from .hamming import hamming_pairwise, hamming_pairwise_onehot
from .lanes import from_numpy_u32

# The grid's y dimension (65535 blocks) times the 128-row tile.
_MAX_ROWS = 65535 * 128

#: The path of the last pairwise_hamming_auto call: "tiled", "onehot" or
#: "plain" (None before the first).
LAST_PAIRWISE_PATH: str | None = None


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


#: Calibrated winner per key (see _calib_key); exposed for tests.
_CALIBRATION: dict[str, str] = {}
# v2: kernel B's 128 x 128 tile redesign; a v1 winner was measured against
# the older kernel and is never read.
_CALIB_VERSION = "v2"
# The calibration problem: a small row block against a large table, the
# shape of the UMI neighbour slabs.  The CPU measures a 16x smaller one.
_CALIB_ROWS, _CALIB_COLS = 512, 16384

_FORMULATIONS = {"tiled": hamming_pairwise_tiled,
                 "onehot": hamming_pairwise_onehot,
                 "plain": hamming_pairwise}


def _candidates(device: torch.device) -> dict:
    names = ("tiled", "onehot") if device.type == "cuda" else ("plain",
                                                               "onehot")
    return {name: _FORMULATIONS[name] for name in names}


def _calib_file() -> str:
    return os.path.join(os.path.expanduser("~/.cache/shortseq_torch"),
                        f"pairwise_calib_{_CALIB_VERSION}.json")


def _calib_key(width: int, device: torch.device) -> str:
    if device.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(device)}/w{width}"
    return f"cpu/w{width}"


def _measure(fn, a, b, runs: int) -> float:
    """Median seconds per call after one warm-up call: CUDA events on the
    card, the host clock on the CPU."""
    fn(a, b)
    times = []
    for _ in range(runs):
        if a.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(a, b)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1000)
        else:
            t0 = time.perf_counter()
            fn(a, b)
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _write_cache(path: str, key: str, winner: str, times: dict) -> None:
    """Add one entry to the disk cache: a read-modify-write under an
    O_EXCL lock (processes calibrating other widths must not drop each
    other's entries), published by an atomic replace.  A stale lock (a
    killed process) is taken over after 30 s; the cache is an
    optimization, so any OSError leaves it as it was."""
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        lock = f"{path}.lock"
        got_lock = False
        for _ in range(100):
            try:
                os.close(os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
                got_lock = True
                break
            except FileExistsError:
                try:
                    if time.time() - os.path.getmtime(lock) > 30:
                        os.unlink(lock)
                        continue
                except OSError:
                    pass
                time.sleep(0.05)
        try:
            try:
                with open(path) as f:
                    disk = json.load(f)
            except (OSError, ValueError):
                disk = {}
            disk[key] = {"winner": winner, "times": times}
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(disk, f)
            os.replace(tmp, path)
        finally:
            if got_lock:
                try:
                    os.unlink(lock)
                except OSError:
                    pass
    except OSError:
        pass


def calibrate_pairwise(width: int, device="cuda", force: bool = False):
    """Time every candidate formulation at this lane width on `device` and
    return {name: seconds}; the winner is cached in memory and on disk
    (~/.cache/shortseq_torch/pairwise_calib_v2.json, keyed by
    cuda/<card name>/w<W> or cpu/w<W>), so one process per machine pays
    the measurement.  Returns None when the winner is already in memory,
    and the stored times when the disk answers."""
    device = _build.resolve_device(device)
    cands = _candidates(device)
    key = _calib_key(width, device)
    path = _calib_file()
    if not force:
        if key in _CALIBRATION:
            return None
        try:
            with open(path) as f:
                entry = json.load(f).get(key)
            if entry and entry.get("winner") in cands:
                _CALIBRATION[key] = entry["winner"]
                return entry["times"]
        except (OSError, ValueError, AttributeError):
            pass
    logging.getLogger(__name__).info(
        "shortseq_torch: one-time pairwise-hamming calibration for %s "
        "(cached at %s; pin a path with SHORTSEQ_TORCH_PAIRWISE)", key, path)
    cuda = device.type == "cuda"
    rows, cols = ((_CALIB_ROWS, _CALIB_COLS) if cuda
                  else (_CALIB_ROWS // 4, _CALIB_COLS // 4))
    rng = np.random.default_rng(0)
    a, b = (from_numpy_u32(rng.integers(0, 2**32, size=(n, width),
                                        dtype=np.uint64).astype(np.uint32))
            .to(device) for n in (rows, cols))
    times = {name: _measure(fn, a, b, runs=5 if cuda else 3)
             for name, fn in cands.items()}
    winner = min(times, key=times.get)
    # The JAX package broadcasts process 0's winner when several processes
    # run one job (pallas_kernels.py:265-280), so all of them agree; that
    # waits for the port's dist/ slice (torch.distributed).
    _CALIBRATION[key] = winner
    _write_cache(path, key, winner, times)
    return times


def pairwise_hamming_auto(a, b) -> torch.Tensor:
    """All-pairs hamming `[N, W] x [M, W] -> [N, M]` int32 by the measured
    fastest exact formulation for the device and lane width (module
    docstring).  Operands are tensors on one device, or numpy uint32
    arrays, which go to the CPU."""
    global LAST_PAIRWISE_PATH
    if isinstance(a, np.ndarray):
        a = from_numpy_u32(a)
    if isinstance(b, np.ndarray):
        b = from_numpy_u32(b)
    mode = os.environ.get("SHORTSEQ_TORCH_PAIRWISE", "")
    if mode and mode not in _FORMULATIONS:
        raise ValueError(f"SHORTSEQ_TORCH_PAIRWISE={mode!r}: expected one "
                         f"of {', '.join(_FORMULATIONS)}")
    if mode == "plain" and a.device.type == "cuda":
        raise ValueError("SHORTSEQ_TORCH_PAIRWISE=plain: the broadcast plain "
                         "version does not run on a CUDA tensor")
    choice = mode
    if not choice:
        key = _calib_key(a.shape[1], a.device)
        if key not in _CALIBRATION:
            calibrate_pairwise(a.shape[1], a.device)
        choice = _CALIBRATION[key]
    out = _FORMULATIONS[choice](a, b)
    pairwise_hamming_auto.paths[choice] += 1
    LAST_PAIRWISE_PATH = choice
    return out


pairwise_hamming_auto.paths = dict.fromkeys(_FORMULATIONS, 0)
