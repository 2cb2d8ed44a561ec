"""BENCHMARK.json keeps to the benchmark's format, and every name in it
has its file under portbench/."""

import json
import math
import re

import pytest

from conftest import PORTBENCH, ROOT
from manifest import Bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level(m):
    assert set(m) == TOP
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert m["command"] == ["python3", "portbench/run.py"]
    assert m["paths"] == ["portbench"]
    assert all(PATH.match(p) and ".." not in p for p in m["paths"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    # A full check of 24 cells fits its budget at this length.
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs(m):
    assert 1 <= len(m["configs"]) <= 24
    used = {w["config"] for w in m["workloads"]}
    files = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["name"] in used
        assert c["file"].startswith("portbench/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and "_dim" not in k for k in c["reduced"])


def test_workloads(m):
    assert 1 <= len(m["workloads"]) <= 24
    names = [w["name"] for w in m["workloads"]]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert line(w["why"]) and w["chips"] in (1, 4)
    four = sum(w["chips"] == 4 for w in m["workloads"])
    assert four <= max(1, math.floor(len(m["workloads"]) / 4))


def test_metrics(m):
    cells = {w["name"] for w in m["workloads"]}
    names = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(m["end_to_end"]) <= 16 and 1 <= len(m["per_layer"]) <= 128
    e2e = {x["name"] for x in m["end_to_end"]}
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    assert {"setup_s", "reads_per_s"} <= e2e
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert x["moves"] in e2e and line(x["layer"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher") and x["source"] in SOURCES
        assert set(x.get("workloads", cells)) <= cells
        assert (PORTBENCH / "metrics" / f"{x['name']}.py").is_file()
    for x in m["per_layer"]:
        if x["name"].endswith("_roofline") or "mfu" in x["name"]:
            assert x["unit"] == "%"


def test_every_cell_reports_enough(m):
    bench = Bench()
    for w in m["workloads"]:
        e2e = {x["name"] for x in bench.metrics(w["name"], False)}
        layer = bench.metrics(w["name"], True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        # A per-layer metric is reported only beside the metric it moves.
        assert all(x["moves"] in e2e for x in layer)
        mix = bench.mix(w["traffic"])
        assert bench.entry(mix["entry"]).LIMITS
        bench.config(w["config"])
