"""The benchmark's manifest and the files it names, found by name.

`BENCHMARK.json` at the checkout's root names the cells, configurations
and metrics; everything that belongs to one of them sits in a file of
its own under `portbench/`:

  configs/<config>.json   a configuration (named by the manifest's `file`)
  mixes/<traffic>.json    a traffic mix: the entry the window drives, its
                          parameters, the environment it sets
  entries/<entry>.py      an entry: `call` one library through the
                          program, `check` the answers and one call's
                          output against the reference
  metrics/<metric>.py     a metric's reader: `read(run)` -> number or
                          None, and what it asks the harness for
                          (COUNTERS, LAUNCHES, probe; see harness.py)

A later cell, mix, entry or metric is a new file and a manifest entry;
no file here needs an edit.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Bench:
    """BENCHMARK.json under `root` (the checkout), and the benchmark's
    files under `root`/portbench (or `here`)."""

    def __init__(self, root: Path | None = None, here: Path | None = None):
        self.here = Path(here or HERE)
        self.root = Path(root or self.here.parent)
        self.manifest = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")

    def config(self, name: str) -> tuple[Path, dict]:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                path = self.root / c["file"]
                return path, json.loads(path.read_text())
        raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return json.loads((self.here / "mixes" / f"{name}.json").read_text())

    def entry(self, name: str):
        return _load(self.here / "entries" / f"{name}.py", f"entry_{name}")

    def reader(self, name: str):
        return _load(self.here / "metrics" / f"{name}.py", f"metric_{name}")

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics the cell reports: its per-layer metrics in a traced
        run, its end-to-end metrics otherwise (a metric with `workloads`
        only in the cells it lists)."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[kind]
                if "workloads" not in m or cell in m["workloads"]]


def _load(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(
        "portbench_" + tag.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
