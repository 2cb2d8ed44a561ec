"""Count-table checkpoint / resume and merges, from
shortseq_tpu/count/checkpoint.py.

Counting is associative, so partial count tables are the natural
checkpoint unit: resume is "load the spilled tables and keep merging", and
a crashed run never recounts finished shards.  Merging N host tables is
one concatenation + one unique_count with the counts as weights.

Format: one .npz per (host, shard) holding the live rows of a table
(words uint32, lengths int32, counts int32), the same arrays the JAX
package spills, so either package resumes the other's directory.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch

from .. import _build
from ..ops.lanes import from_numpy_u32
from .device import empty_table, unique_count

__all__ = ["check_manifest", "completed_shards", "empty_table",
           "file_fingerprint", "load_table", "merge_host_tuples",
           "merge_tables", "save_table", "shard_path"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def save_table(path, u_words, u_lengths, u_counts, n_unique) -> None:
    """Spill the first n_unique rows of a count table (tensors on any
    device, or host arrays) to `path` (.npz, atomic via rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = int(n_unique)
    words = _host(u_words[:n])
    if words.dtype == np.int32:  # the port's lanes: uint32 bits in int32
        words = words.view(np.uint32)
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(
        tmp, words=words,
        lengths=_host(u_lengths[:n]).astype(np.int32, copy=False),
        counts=_host(u_counts[:n]).astype(np.int32, copy=False))
    os.replace(tmp, path)


def load_table(path):
    """Load a spilled table -> (words [M, W] uint32, lengths [M] int32,
    counts [M] int32) host arrays."""
    with np.load(path) as z:
        return z["words"], z["lengths"], z["counts"]


def check_manifest(directory, **params) -> None:
    """Guard against resuming with incompatible parameters: shard tables
    are keyed by (host, shard), so reusing a checkpoint dir with a
    different file / shard count / host count would silently merge wrong
    counts.  Writes `manifest.json` on first use; raises if an existing
    manifest disagrees."""
    import json

    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "manifest.json"
    if path.exists():
        existing = json.loads(path.read_text())
        if existing != params:
            raise ValueError(
                f"checkpoint dir {directory} was written with "
                f"{existing}, now asked to resume with {params}; "
                "clear the directory or use a fresh one")
        return
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(params))
    os.replace(tmp, path)


def file_fingerprint(path, n_probes: int = 16) -> str:
    """Content fingerprint guarding checkpoint resume against a modified
    input of identical size.  Files <= 32 MiB are hashed in full
    (sha256); larger files hash the size, the first and last 64 KiB, and
    64 KiB probes at n_probes evenly spaced interior offsets (an edit
    between probes can escape: the stated trade-off for keeping resume
    O(MiB) on arbitrarily large inputs)."""
    import hashlib

    size = os.path.getsize(path)
    h = hashlib.sha256()
    h.update(str(size).encode())
    block = 65536
    with open(path, "rb") as f:
        if size <= (32 << 20):
            for chunk in iter(lambda: f.read(1 << 20), b""):
                h.update(chunk)
            return h.hexdigest()[:32]
        h.update(f.read(block))
        for i in range(1, n_probes + 1):
            off = size * i // (n_probes + 1)
            if off <= block or off >= size - block:
                continue
            f.seek(off)
            h.update(f.read(block))
        f.seek(size - block)
        h.update(f.read(block))
    return h.hexdigest()[:32]


def shard_path(directory, host: int, shard: int) -> Path:
    return Path(directory) / f"counts_h{host:04d}_s{shard:06d}.npz"


def completed_shards(directory, host: int):
    """Shard indices already checkpointed for `host` (for resume)."""
    directory = Path(directory)
    if not directory.is_dir():
        return set()
    prefix = f"counts_h{host:04d}_s"
    out = set()
    for p in directory.glob(f"{prefix}*.npz"):
        try:
            out.add(int(p.stem[len(prefix):]))
        except ValueError:
            continue
    return out


def merge_host_tuples(host_tables, n_out: int | None = None, device="cuda"):
    """Merge host (words uint32 [M, W], lengths int32 [M], counts [M])
    tuples exactly: one zero-padded concat + one unique_count on `device`
    ("cuda" raises without a card; "cpu" runs the plain versions).
    Narrower tables are zero-padded to the widest width.  Returns the
    (u_words, u_lengths, u_counts, n_unique) tensors on `device`, with
    n_out rows when given (an n_out below the group count keeps the first
    n_out groups, and fetch_table raises on the table).

    Counts are narrowed to int32, as in the JAX package; a count that does
    not fit wraps and is the caller's to avoid (every table this package
    produces holds int32 counts)."""
    device = _build.resolve_device(device)
    widths = [w.shape[1] for w, _, _ in host_tables if w.size]
    width = max(widths) if widths else 1
    total = sum(len(l) for _, l, _ in host_tables)
    if total == 0:
        return empty_table(width, device)
    words = np.zeros((total, width), np.uint32)
    lengths = np.empty(total, np.int32)
    counts = np.empty(total, np.int32)
    row = 0
    for w, l, c in host_tables:
        words[row:row + len(l), :w.shape[1]] = w
        lengths[row:row + len(l)] = l
        counts[row:row + len(l)] = c
        row += len(l)
    return unique_count(from_numpy_u32(words).to(device),
                        torch.from_numpy(lengths).to(device),
                        torch.from_numpy(counts).to(device), n_out=n_out)


def merge_tables(paths, n_out: int | None = None, device="cuda"):
    """Merge spilled tables exactly: concatenate + one unique_count on
    `device`.  Returns (u_words, u_lengths, u_counts, n_unique)."""
    return merge_host_tuples([load_table(p) for p in paths], n_out=n_out,
                             device=device)
