"""The reduction of a torch.profiler Chrome trace to what the per-layer
metrics read: the device's busy intervals, the host ranges (the
program's `ssq.*` ranges and the benchmark's `portbench.*` spans), the
device work launched inside a range, and the idle gaps labelled by what
the host was doing.

Times are the trace's microseconds.  A device event is a kernel, a copy
or a memset; it belongs to a host range when the runtime (or driver)
call that launched it, matched by its correlation id, falls inside the
range.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_CAT = "user_annotation"
WINDOW = "portbench.window"


def union(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, lo, hi) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


class Trace:
    def __init__(self, events):
        self.ranges = {}    # name -> [(start, end)]
        self.launch = {}    # correlation -> launch time
        self.device = []    # (start, end, name, correlation)
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            args = e.get("args") or {}
            ts, dur = float(e["ts"]), float(e.get("dur", 0))
            if cat == RANGE_CAT:
                self.ranges.setdefault(e["name"], []).append((ts, ts + dur))
            elif cat in LAUNCH_CATS:
                self.launch[args.get("correlation")] = ts
            elif cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e["name"],
                                    args.get("correlation")))
        spans = self.ranges.get(WINDOW) or [(0.0, 0.0)]
        self.window = max(spans, key=lambda s: s[1] - s[0])
        lo, hi = self.window
        # The window's device events: those that run inside it.
        self.device = [d for d in self.device if d[1] > lo and d[0] < hi]
        self._labels = sorted((a, b, name) for name, spans in
                              self.ranges.items() if name != WINDOW
                              for a, b in spans)
        self._label_starts = [s[0] for s in self._labels]
        self._bounds = sorted(t for a, b, _ in self._labels for t in (a, b))

    @classmethod
    def load(cls, path) -> "Trace":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy(self) -> list:
        return clip(union((a, b) for a, b, _, _ in self.device), *self.window)

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy())

    def gaps(self) -> list:
        """The window's idle intervals: no device event runs."""
        lo, hi = self.window
        out, t = [], lo
        for a, b in self.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if hi > t:
            out.append((t, hi))
        return out

    def label(self, t: float) -> str:
        """The innermost host range open at time t (the one that started
        last among those that hold t), or "no range"."""
        i = bisect.bisect_right(self._label_starts, t)
        for a, b, name in reversed(self._labels[:i]):
            if b >= t:
                return name
        return "no range"

    def idle_by_label(self) -> dict:
        """Idle microseconds of the window by what the host was doing:
        each gap cut at the host ranges' boundaries, and each piece
        given the innermost range open in it."""
        out = {}
        for a, b in self.gaps():
            lo = bisect.bisect_right(self._bounds, a)
            hi = bisect.bisect_left(self._bounds, b)
            cuts = [a, *self._bounds[lo:hi], b]
            for x, y in zip(cuts, cuts[1:]):
                name = self.label((x + y) / 2)
                out[name] = out.get(name, 0.0) + (y - x)
        return out

    def launched_in(self, name: str) -> list:
        """The window's device events launched inside a range `name`."""
        spans = sorted(self.ranges.get(name, ()))
        starts = [s[0] for s in spans]
        out = []
        for d in self.device:
            t = self.launch.get(d[3])
            if t is None:
                continue
            i = bisect.bisect_right(starts, t)
            if i and spans[i - 1][1] >= t:
                out.append(d)
        return out

    def op_totals(self) -> dict:
        """Device microseconds of the window by event name."""
        out = {}
        for a, b, name, _ in self.device:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def count(self, fragment: str) -> int:
        """Device events whose name holds `fragment`."""
        return sum(fragment in d[2] for d in self.device)


def top(totals: dict, n: int = 10) -> list:
    """[[name, seconds], ...] of the n largest microsecond totals."""
    best = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name, us / 1e6] for name, us in best]
