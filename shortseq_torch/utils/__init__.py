"""Host utilities: phase timing."""

from .profiling import PhaseTimings, phase_timer

__all__ = ["PhaseTimings", "phase_timer"]
