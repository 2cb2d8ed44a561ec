"""Host utilities: CUDA warmup, phase timing, profiler ranges and traces,
debug dumps, deep object sizes."""

from .debug import dump_lanes, printbin
from .memory import deep_sizeof
from .profiling import PhaseTimings, named_scope, phase_timer, trace
from .warmup import start_transfer_warmup

__all__ = [
    "start_transfer_warmup",
    "PhaseTimings", "phase_timer", "named_scope", "trace",
    "printbin", "dump_lanes", "deep_sizeof",
]
