"""What a run loads: nothing of JAX or the JAX package, and a reference
that loads nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from conftest import PORTBENCH, ROOT
from helpers import CELLS

FORBIDDEN = {"jax", "jaxlib", "flax", "shortseq_tpu"}
SOURCES = [p for p in PORTBENCH.rglob("*.py") if "tests" not in p.parts]


def imported(path):
    """Top-level names of the modules a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax_and_no_jax_tooling():
    for path in SOURCES:
        names = imported(path)
        assert not names & FORBIDDEN, path
        # The JAX package's benchmark and the chip smoke script.
        assert not names & {"bench", "benchmarks", "chip_smoke"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        assert imported(path) <= {"__future__", "dataclasses", "numpy",
                                  "torch"}, path
    code = ("import sys; sys.path.insert(0, %r); "
            "from reference import count; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(PORTBENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert "shortseq_torch" not in loaded and not loaded & FORBIDDEN


@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_loads_no_jax(tmp_path, trace):
    """A whole run of each cell (set-up, window, check) on the CPU, in a
    fresh process: the top-level names of every module it loaded."""
    code = f"""
import sys, time, json
sys.path[:0] = [{str(PORTBENCH)!r}, {str(ROOT)!r},
                {str(PORTBENCH / 'tests')!r}]
import harness
from conftest import tiny_copy
from pathlib import Path
b = tiny_copy(Path({str(tmp_path)!r}))
for i, name in enumerate({list(CELLS)!r}):
    w = Path({str(tmp_path)!r}) / f"w{{i}}"
    w.mkdir()
    r, _ = harness.measure(b, b.cell(name), 3, 0.2, {trace}, "cpu", w,
                           time.perf_counter())
    assert r["correct"], name
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "shortseq_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_run_refuses_a_loaded_jax_name(tiny, tmp_path, monkeypatch):
    import harness
    from helpers import run_cell

    monkeypatch.setitem(sys.modules, "shortseq_tpu", object())
    with pytest.raises(harness.ForbiddenModules) as e:
        run_cell(tiny, CELLS[0], tmp_path)
    assert e.value.names == ["shortseq_tpu"]
