"""The peaks leave out the one output the harness keeps for the check:
an entry whose output is a 64 MiB host array reports a host peak that
the array's bytes do not raise."""

import json
import re

from helpers import run_cell

HEAVY_ENTRY = '''"""Entry heavy: the table's total, and a 64 MiB array as its output."""

import numpy as np

LIMITS = {"calls_wrong": 0}


def call(st, path, mix, spans, device):
    with spans.span("portbench.count"):
        t = st.read_and_count_fastq_table(path, engine="device",
                                          device=device)
    out = np.ones(8 << 20)  # 64 MiB, touched
    return {"total": t.total()}, out, t._read_seconds



def check(answers, kept, ref, mix, rng):
    return {"calls_wrong": sum(a["total"] != ref.reads for a in answers)}
'''


def test_kept_output_is_left_out_of_the_host_peak(tiny, tmp_path):
    here = tiny.here
    (here / "entries" / "heavy.py").write_text(HEAVY_ENTRY)
    (here / "mixes" / "heavy.json").write_text(json.dumps({
        "entry": "heavy", "env": {}}))
    m = tiny.manifest
    m["workloads"].append({"name": "heavy", "config": "smallrna_10m",
                           "traffic": "heavy", "chips": 1, "why": "test"})
    (tiny.root / "BENCHMARK.json").write_text(json.dumps(m))
    import manifest

    bench = manifest.Bench(tiny.root, here)
    result, log = run_cell(bench, "heavy", tmp_path, seconds=1.0)
    assert result["correct"]
    line = next(x for x in log if x.startswith("peaks:"))
    raw, hold = map(int, re.search(r"host (\d+) B .* less (\d+) B",
                                   line).groups())
    assert 60 << 20 <= hold <= 70 << 20, line
    assert result["metrics"]["peak_host_rss_mib"]["value"] == \
        (raw - hold) / 2**20
