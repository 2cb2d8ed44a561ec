"""On the card: one short traced run of each cell through
`portbench/run.py`, its last line a correct result.  Skips without a
CUDA device."""

import json
import subprocess
import sys

import pytest

from conftest import PORTBENCH, ROOT
from helpers import CELLS


@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(cuda, name):
    proc = subprocess.run(
        [sys.executable, str(PORTBENCH / "run.py"), "--workload", name,
         "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
