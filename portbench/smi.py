"""The card's name, power limit, SM clock and power draw, read by
nvidia-smi (which reads them and can set nothing)."""

from __future__ import annotations

import statistics
import subprocess


class Query:
    """One nvidia-smi query of the card's name and power limit, started
    at once and read later, so that it overlaps the set-up."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def result(self) -> str:
        if self.proc is None:
            return "nvidia-smi: not found"
        try:
            out, _ = self.proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()
            return "nvidia-smi: timed out"
        lines = out.strip().splitlines()
        return lines[0] if lines else "nvidia-smi: no answer"


class Sampler:
    """The SM clock and power draw, sampled by nvidia-smi every
    `period_ms` in the background while the `with` block runs."""

    def __init__(self, period_ms: int = 500):
        self.period_ms = period_ms
        self.samples = []
        self.proc = None

    def __enter__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader,nounits", "-lms",
                 str(self.period_ms)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None
        return self

    def __exit__(self, *exc):
        if self.proc is None:
            return False
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                mhz, watts = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((mhz, watts))
        return False

    def summary(self) -> str:
        if not self.samples:
            return "clocks.sm and power.draw: not sampled"
        mhz, watts = zip(*self.samples)
        return (f"clocks.sm {min(mhz):.0f}-{max(mhz):.0f} MHz (median "
                f"{statistics.median(mhz):.0f}), power.draw {min(watts):.1f}-"
                f"{max(watts):.1f} W (median {statistics.median(watts):.1f}) "
                f"over {len(mhz)} samples")
