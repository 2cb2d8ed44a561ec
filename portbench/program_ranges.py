"""What the program's own ranges and transfer counters give the per-layer
readers (metrics/*.py): the share of the traced window that a range
covers, or that it covers with no other program range inside it, and the
program's transfer counters.

Each reads what a traced run holds and returns None where it finds
nothing: a run without a trace, or a program that has no such range or
counter (a counter is declared only where the program has it, so that
the harness reads none that is not there)."""

from __future__ import annotations

import importlib

import tracefile

#: The program's range names start so (utils/profiling.py in the program).
PREFIX = "ssq."
#: The module whose h2d and d2h helpers carry the transfer counters (the
#: default module of `counter`).
TRANSFERS = "shortseq_torch.count.device"


def _covered(trace, names) -> list:
    """Sorted disjoint intervals: the union of the ranges of `names`,
    clipped to the window."""
    spans = [s for n in names for s in trace.ranges.get(n, ())]
    return tracefile.clip(tracefile.union(spans), *trace.window)


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    out, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            out += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _traced(run, name) -> bool:
    return (run.trace is not None and run.trace.window_us > 0
            and name in run.trace.ranges)


def span_us(run, name: str):
    """Microseconds of the window inside a range `name`, or None."""
    return _length(_covered(run.trace, [name])) if _traced(run, name) \
        else None


def share(run, name: str):
    """The window's share (%) inside a range `name`, or None."""
    us = span_us(run, name)
    return None if us is None else 100 * us / run.trace.window_us


def self_share(run, name: str):
    """The window's share (%) inside a range `name` and inside no other
    program range (the range's own code, between its stages), or None."""
    if not _traced(run, name):
        return None
    tr = run.trace
    own = _covered(tr, [name])
    others = _covered(tr, [n for n in tr.ranges
                           if n.startswith(PREFIX) and n != name])
    return 100 * (_length(own) - _overlap(own, others)) / tr.window_us


def counter(helper: str, attr: str, module: str = TRANSFERS):
    """The harness's name ("module:helper.attr") of the counter `attr` of
    `helper` in the program's `module`, or None where the program has no
    such counter."""
    try:
        mod = importlib.import_module(module)
    except ImportError:
        return None
    if not hasattr(getattr(mod, helper, None), attr):
        return None
    return f"{module}:{helper}.{attr}"


def per_read(run, spec):
    """A counter's growth over the window, over the reads of its finished
    calls, or None."""
    done = sum(c["ok"] for c in run.calls)
    if spec is None or spec not in run.counters or not done:
        return None
    return run.counters[spec] / (run.reads * done)
