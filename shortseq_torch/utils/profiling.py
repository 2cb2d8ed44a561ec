"""Phase timing for the reference-style timing print (reference
counter.pyx:62-70), from shortseq_tpu/utils/profiling.py."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


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
