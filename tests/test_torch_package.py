"""shortseq_torch as a package: it imports with jax blocked, names neither
jax nor shortseq_tpu in any import, builds nothing at import, never hides
a missing card behind the CPU, and its chip smoke script refuses to run
without one."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "shortseq_torch"
BLOCKED = ("jax", "jaxlib", "shortseq_tpu")


def _run(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_imports_with_jax_blocked():
    code = (
        "import sys\n"
        f"for name in {BLOCKED!r}:\n"
        "    sys.modules[name] = None\n"
        "import shortseq_torch, shortseq_torch.umi.dedup\n"
        "import shortseq_torch.__main__, shortseq_torch.io.fastq\n"
        "import shortseq_torch.ops, shortseq_torch.io.bgzf\n"
        "import shortseq_torch.api, shortseq_torch.api.counter\n"
        "import shortseq_torch.api.seq, shortseq_torch.oracle\n"
        "import shortseq_torch.count, shortseq_torch.count.checkpoint\n"
        "import shortseq_torch.count.ingest, shortseq_torch.utils\n"
        "import shortseq_torch.batch, shortseq_torch.umi.objects\n"
        "import shortseq_torch.ops.pairwise, shortseq_torch.ops.hamming\n"
        "from shortseq_torch import _build\n"
        "from shortseq_torch.io import native\n"
        "assert _build._cuda is None and not native._bound\n"
        "assert not _build._objects_tried\n"
        "assert 'BACKEND' not in vars(shortseq_torch.api)\n"
        "print(shortseq_torch.__version__)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip()


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in BLOCKED, (path, name)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from shortseq_torch import dedup_reads, dedup_umis

    with pytest.raises(RuntimeError, match="CUDA"):
        dedup_umis([b"AAAA", b"AAAT"])
    with pytest.raises(RuntimeError, match="CUDA"):
        dedup_reads(["AAAACGT"], len_5p=4, device="cuda")


@pytest.mark.parametrize("call", ["table", "counter", "matrix", "cli"])
def test_device_engine_without_card_raises(tmp_path, capsys, call):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    import shortseq_torch as st
    from shortseq_torch.__main__ import main
    from shortseq_torch.api.counter import count_matrix_device

    path = tmp_path / "r.fastq"
    path.write_bytes(b"@r\nACGT\n+\nIIII\n")
    if call == "cli":
        assert main(["count", str(path), "--engine", "device"]) == 2
        assert "CUDA" in capsys.readouterr().err
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        if call == "table":
            st.read_and_count_fastq_table(path, engine="device")
        elif call == "counter":
            st.read_and_count_fastq(path, engine="device", device="cuda")
        else:
            count_matrix_device(np.full((1, 16), 65, np.uint8),
                                np.array([4], np.int32))


def test_kernel_wrappers_count_no_cpu_launches():
    import numpy as np

    from shortseq_torch.api.counter import count_matrix_device
    from shortseq_torch.count.device import group_count
    from shortseq_torch.ops import (hamming_pairwise_tiled,
                                    pack_and_validate_u32)
    from shortseq_torch.umi.dedup import dedup_umis, neighbor_extract

    from shortseq_torch import PackedBatch, pack_batch
    from shortseq_torch.batch import trim_words_ragged
    from shortseq_torch.ops import hamming_rows, pack_words_u32, unpack_ascii

    wrappers = (pack_and_validate_u32, hamming_pairwise_tiled,
                neighbor_extract, group_count, pack_words_u32, unpack_ascii,
                trim_words_ragged, hamming_rows)
    before = [w.launches for w in wrappers]
    dedup_umis([b"AAAA", b"AAAT", b"GGGG"], device="cpu")
    counts = count_matrix_device(np.full((3, 16), 65, np.uint8),
                                 np.array([4, 4, 2], np.int32), device="cpu")
    assert sorted(counts.values()) == [1, 2]
    b = pack_batch(["ACGT", "GGA"], device="cpu")
    m = PackedBatch.from_matrix(np.full((2, 16), 65, np.uint8), [3, 4],
                                device="cpu")
    assert b.trim(1, 2).decode() == ["CG", "GA"]
    assert b.trim_ragged([0, 1], 2).hamming(m.trim(0, 2)).tolist() == [1, 1]
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_card(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = ROOT / "chip_smoke.py"
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not any(line.lstrip().startswith("{")
                   for line in proc.stdout.splitlines()), proc.stdout
