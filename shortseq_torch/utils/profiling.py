"""Phase timing for the reference-style timing print (reference
counter.pyx:62-70), named profiler ranges around the kernels' wrappers
and the count path's host stages, and a trace context, from
shortseq_tpu/utils/profiling.py.

The JAX package names its kernels with jax.named_scope so that XLA traces
show them; here a named range is a torch.profiler.record_function, which
torch.profiler traces (and TensorBoard or chrome://tracing shows) with
each kernel's launch inside it.  The kernels' wrappers take theirs through
the `scoped` decorator.  A range opens only while a profiler records, so
with none it costs one flag read.

The FASTQ count path marks its host stages too, so that every gap in the
card's timeline falls inside a range that says what the host was doing.
One library call is one tree under its root:

  ssq.read_count    read_and_count_fastq(_table): the root of one call
    ssq.file_read   the file's bytes into memory (one a streamed slice)
    ssq.index       the line index of those bytes
    ssq.gather_pack host gather + 2-bit pack + validate, one a bucket
    ssq.h2d         a copy to the card (count/device.py h2d)
    ssq.unique_count  the sort and group count (kernels S, D, I)
      ssq.hash_count  its route for rows over 6 lanes: each hash
                      family's I, S and D and the host's read of D's
                      collision word (never opened at 6 lanes or fewer)
    ssq.d2h         a blocking read of a card tensor (count/device.py
                    d2h): the host's wait for the card's queue and the
                    copy
    ssq.merge       the streamed path's merge of its slices' tables
  ssq.to_counter    CountTable.to_counter / table_to_counter: the dict
    ssq.objects     the ShortSeq objects and the dict's inserts
  ssq.table_read    CountTable's lazy reads (most_common, total, get,
                    values, `in`, `[]`)

The UMI path marks its stages alike; one call of umi.dedup.dedup_fastq
(the CLI's `umi`) is one tree under its root:

  ssq.umi_dedup       dedup_fastq: the root of one call
    ssq.umi_read      read_fastq_matrix: the padded read matrix and
                      its lengths
    ssq.umi_group     the _unique_rows passes (native, or numpy without
                      the native library), the length buckets and the
                      re-rank into first-occurrence order
    ssq.umi_pack      kernel A with its copies (_pack_validate_matrix)
    ssq.umi_neighbors _neighbor_lists: kernel H, the overflow tier, the
                      fetch and the lists' CSR
    ssq.umi_collapse  the walk over that CSR, _relabel, the molecule tuples
                      and the reads per molecule (more than one a call)

dedup_reads called alone opens the same stages with no root, and
dedup_umis all of them but ssq.umi_group.  `_neighbor_lists` counts its
work on itself (`.rows`, `.pairs`, `.group_pairs`, `.overflow_rows`,
`.edges`, `.umi_lanes`; umi/dedup.py), and the one read path
`_dedup_reads_ragged` every read it took, by the form it came in:
`.padded_reads` (a padded matrix taken as it is: every read of
dedup_fastq, and a uint8 matrix given to dedup_reads) and `.list_reads`
(a list that dedup_reads laid into that form).

ssq.h2d and ssq.d2h open wherever a copy is made (on a CPU device too,
where nothing crosses); ssq.to_counter is a root of its own when called
on a table.  A range of one name never holds another of that name.
`trace(log_dir)` around a pipeline call records them beside the kernels
and copies.  The bytes and the number of copies that cross between the
host and a CUDA device are counted on the helpers themselves:
`count.device.h2d.bytes` / `.copies` and `count.device.d2h.bytes` /
`.copies` (every d2h copy blocks, so its `.copies` counts the host's
syncs).  `count.ingest.packed_buckets.lane_bytes` counts the bytes of
the packed lanes the host yields."""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field

import torch


@dataclass
class PhaseTimings:
    """Accumulated wall times per phase, in seconds."""

    phases: dict = field(default_factory=dict)

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + seconds

    def report(self) -> str:
        return ", ".join(f"{k}: {v:.2f}s" for k, v in self.phases.items())


@contextlib.contextmanager
def phase_timer(name: str, timings: PhaseTimings | None = None,
                echo: bool = False):
    """Wall-time a pipeline phase; optionally accumulate into `timings`
    and/or print "name: 0.00s" (the reference's phase prints)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if timings is not None:
            timings.add(name, dt)
        if echo:
            print(f"{name}: {dt:.2f}s")


# Whether a torch profiler records: the autograd profiler's Python flag
# (one attribute read), or, where the installed torch lacks it, the C++
# query.
_autograd_profiler = torch.autograd.profiler
if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiler_active() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:
    _profiler_active = torch._C._autograd._profiler_enabled


class _NoRange:
    """The context of named_scope when nothing traces."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_RANGE = _NoRange()


def named_scope(name: str):
    """A torch.profiler range named `name` around a `with` block, opened
    only while a profiler records: record_function is a dispatcher call
    of several microseconds even when nothing traces.  Exceptions from
    the block propagate."""
    if _profiler_active():
        return torch.profiler.record_function(name)
    return _NO_RANGE


def scoped(name: str):
    """Decorator: the function runs inside named_scope(name), with the
    profiler check made before the call, so that a kernel's wrapper (15-70
    us a call on the card's hosts) pays one flag read and one Python call
    when nothing traces.  The undecorated function is `__wrapped__`."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _profiler_active():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return run

    return wrap


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (CPU activity, plus CUDA when a
    card is present), written into `log_dir` as a Chrome/TensorBoard trace
    file when the block ends; yields the profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) as prof:
        yield prof
