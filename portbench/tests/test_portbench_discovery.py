"""A configuration, a mix, an entry and a metric dropped into a copy of
the benchmark are found by their names, with no file edited."""

import json

from conftest import PORTBENCH
from helpers import run_cell

EXTRA_METRIC = '''"""extra.calls: the window's library calls."""


def read(run):
    return len(run.calls)
'''

PROBED_METRIC = '''"""extra.probed_calls: the window's calls into the program's entry
point, counted by a probe and read as a counter's growth."""

import sys
import types

_counter = sys.modules.setdefault("extra_probe_counter",
                                  types.ModuleType("extra_probe_counter"))
_counter.calls = getattr(_counter, "calls", 0)
COUNTERS = ("extra_probe_counter:calls",)


class Probe:
    def __init__(self, package):
        self.package, self.resets = package, 0
        self.orig = package.read_and_count_fastq_table

        def counted(*args, **kwargs):
            _counter.calls += 1
            return self.orig(*args, **kwargs)

        package.read_and_count_fastq_table = counted

    def reset(self):
        self.resets += 1

    def undo(self):
        self.package.read_and_count_fastq_table = self.orig


def probe(program):
    return Probe(program.package)


def read(run):
    assert run.probes["extra.probed_calls"].resets == 1
    return run.counters["extra_probe_counter:calls"]
'''

EXTRA_ENTRY = '''"""Entry extra_total: only the table's total."""

LIMITS = {"calls_wrong": 0}


def call(st, path, mix, spans, device):
    with spans.span("portbench.count"):
        t = st.read_and_count_fastq_table(path, engine="device",
                                          device=device)
    return {"total": t.total()}, None, t._read_seconds



def check(answers, kept, ref, mix, rng):
    return {"calls_wrong": sum(a["total"] != ref.reads for a in answers)}
'''


def test_new_files_found_by_name(tiny, tmp_path):
    before = {p.name: p.read_bytes() for p in PORTBENCH.glob("*.py")}
    here = tiny.here
    (here / "configs" / "extra_1k.json").write_text(json.dumps({
        "name": "extra_1k", "source": "test", "reduced": [],
        "library": {"reads": 1000, "length_min": 40, "length_max": 60,
                    "molecules": 50, "zipf_s": 1.0}}))
    (here / "mixes" / "extra.json").write_text(json.dumps({
        "entry": "extra_total", "env": {}}))
    (here / "entries" / "extra_total.py").write_text(EXTRA_ENTRY)
    (here / "metrics" / "extra.calls.py").write_text(EXTRA_METRIC)
    (here / "metrics" / "extra.probed_calls.py").write_text(PROBED_METRIC)
    m = tiny.manifest
    m["configs"].append({"name": "extra_1k", "source": "test",
                         "file": "portbench/configs/extra_1k.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "extra-1k.total", "config": "extra_1k",
                           "traffic": "extra", "chips": 1, "why": "test"})
    # The rate is end to end only in the cells it lists.
    rate = next(x for x in m["end_to_end"] if x["name"] == "reads_per_s")
    rate["workloads"].append("extra-1k.total")
    m["per_layer"].append({"name": "extra.calls", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "Count API", "moves": "reads_per_s",
                           "workloads": ["extra-1k.total"]})
    m["per_layer"].append({"name": "extra.probed_calls", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "Count API", "moves": "reads_per_s",
                           "workloads": ["extra-1k.total"]})
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(m))
    import manifest

    import shortseq_torch

    entry_point = shortseq_torch.read_and_count_fastq_table
    bench = manifest.Bench(tiny.root, here)
    result, _ = run_cell(bench, "extra-1k.total", tmp_path, trace=1)
    assert result["correct"]
    assert result["metrics"]["extra.calls"]["value"] == result["attempted"]
    # The probe counted the window's calls only, and was undone.
    assert result["metrics"]["extra.probed_calls"]["value"] == \
        result["attempted"]
    assert shortseq_torch.read_and_count_fastq_table is entry_point
    result, _ = run_cell(bench, "extra-1k.total", tmp_path, trace=0)
    assert result["correct"] and "reads_per_s" in result["metrics"]
    # The other cells do not report the new metric.
    result, _ = run_cell(bench, "smallrna-10m.streamed", tmp_path, trace=1)
    assert "extra.calls" not in result["metrics"]
    assert "extra.probed_calls" not in result["metrics"]
    assert {p.name: p.read_bytes() for p in PORTBENCH.glob("*.py")} == before
