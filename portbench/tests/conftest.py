"""Fixtures of the benchmark's CPU tests.

Run from the checkout's root:  python -m pytest portbench/tests -q
(the card's test, test_portbench_card.py, skips where there is no CUDA
device; on the card's machine the same command runs it).
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

PORTBENCH = Path(__file__).resolve().parent.parent
ROOT = PORTBENCH.parent
for p in (str(ROOT), str(PORTBENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

import manifest  # noqa: E402

#: Library sizes of the tiny copies: every configuration at this many
#: reads (molecules scaled alike), small enough for the CPU.
TINY_READS = 3000


def tiny_copy(dst: Path, reads: int = TINY_READS) -> manifest.Bench:
    """A copy of the benchmark under `dst` (BENCHMARK.json and
    portbench/) with every library cut to `reads` reads and streamed
    slices of 40 kB, so that each cell runs on the CPU in a second."""
    shutil.copytree(PORTBENCH, dst / "portbench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in bench["configs"]:
        path = dst / c["file"]
        cfg = json.loads(path.read_text())
        lib = cfg["library"]
        if lib["molecules"]:
            lib["molecules"] = max(1, lib["molecules"] * reads // lib["reads"])
        lib["reads"] = reads
        path.write_text(json.dumps(cfg))
    mix = dst / "portbench" / "mixes" / "streamed.json"
    m = json.loads(mix.read_text())
    m["env"]["SHORTSEQ_TORCH_STREAM_BYTES"] = "40000"
    mix.write_text(json.dumps(m))
    return manifest.Bench(dst, dst / "portbench")


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch
