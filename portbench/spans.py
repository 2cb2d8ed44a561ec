"""The benchmark's own host spans around the calls into the program's
layers, kept per library call; in a traced run each is also a
torch.profiler range of the same name."""

from __future__ import annotations

import contextlib
import time


class Spans:
    def __init__(self, trace: bool = False):
        self.trace = trace
        self.calls = []   # one {span name: seconds} a library call

    def new_call(self) -> dict:
        self.calls.append({})
        return self.calls[-1]

    @contextlib.contextmanager
    def span(self, name: str):
        rng = contextlib.nullcontext()
        if self.trace:
            import torch

            rng = torch.profiler.record_function(name)
        with rng:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if self.calls:
                    cur = self.calls[-1]
                    cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
