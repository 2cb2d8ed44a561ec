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


@contextlib.contextmanager
def phase_timer(name: str, timings: PhaseTimings):
    """Wall-time a pipeline phase into `timings`."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timings.add(name, time.perf_counter() - t0)
