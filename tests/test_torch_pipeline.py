"""shortseq_torch's checkpointed byte-range pipeline (dist/pipeline.py
count_fastq_sharded, count/checkpoint.py) against shortseq_tpu's on the
same files: shard boundaries lose no records, spills are the same arrays,
either package resumes the other's checkpoint directory, and a crashed
run resumes recounting only the missing shards.  Mirrors
tests/test_pipeline_checkpoint.py and tests/test_crash_resume.py; the
port runs its plain versions (device="cpu").

Tables are compared array for array at every width: both packages order
reads up to 96 nt by key and the 64-lane bucket by the row hash."""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import shortseq_torch.count.checkpoint as tck
import shortseq_torch.dist.pipeline as tpl
import shortseq_tpu.count.checkpoint as jck
import shortseq_tpu.dist.pipeline as jpl
from shortseq_torch.config import PipelineConfig
from shortseq_tpu.config import PipelineConfig as JaxConfig
from tests.conftest import REPO_ROOT

ALPHA = np.frombuffer(b"ACGT", np.uint8)


def _write(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i} x{'y' * (i % 5)}\n{r}\n+\n{'J' * len(r)}\n")
    return str(path)


def _reads(seed, n=300, hi=40):
    rng = np.random.default_rng(seed)
    reads = [ALPHA[rng.integers(0, 4, size=int(k))].tobytes().decode()
             for k in rng.integers(5, hi + 1, size=n)]
    return reads + reads[::3]


@pytest.fixture
def narrow(tmp_path):
    reads = _reads(1)
    return _write(tmp_path / "narrow.fastq", reads), reads


@pytest.fixture
def mixed(tmp_path):
    reads = _reads(2, hi=150)
    return _write(tmp_path / "mixed.fastq", reads), reads


def _as_dict(table):
    return {str(k): v for k, v in tpl.table_to_counter(table).items()}


def _host(table, mod):
    w, l, c = mod._table_to_host(table)
    return np.asarray(w, np.uint32), np.asarray(l), np.asarray(c)


def _same(got, want):
    """Equal live tables, array for array."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shards", [1, 5])
@pytest.mark.parametrize("files", ["narrow", "mixed"])
def test_sharded_count_matches_jax(request, files, shards):
    path, reads = request.getfixturevalue(files)
    got = tpl.count_fastq_sharded(path, n_shards=shards, device="cpu")
    want = jpl.count_fastq_sharded(path, n_shards=shards)
    assert _as_dict(got) == dict(collections.Counter(reads))
    _same(_host(got, tpl), _host(want, jpl))


@pytest.mark.parametrize("files", ["narrow", "mixed"])
def test_two_hosts_then_merged_matches_jax(request, files):
    path, reads = request.getfixturevalue(files)
    got = [tpl.count_fastq_sharded(path, n_shards=4, host=h, n_hosts=2,
                                   device="cpu") for h in range(2)]
    want = [jpl.count_fastq_sharded(path, n_shards=4, host=h, n_hosts=2)
            for h in range(2)]
    for g, w in zip(got, want):
        _same(_host(g, tpl), _host(w, jpl))
    merged = tck.merge_host_tuples([tpl._table_to_host(t) for t in got],
                                   device="cpu")
    assert _as_dict(merged) == dict(collections.Counter(reads))


def test_batch_chunking_matches_jax(tmp_path):
    reads = _reads(3, n=100, hi=16) * 2
    path = _write(tmp_path / "c.fastq", reads)
    got = tpl.count_fastq_sharded(
        path, config=PipelineConfig(batch_size=64), device="cpu")
    want = jpl.count_fastq_sharded(
        path, config=JaxConfig(batch_size=64, min_batch_pad=64))
    assert _as_dict(got) == dict(collections.Counter(reads))
    _same(_host(got, tpl), _host(want, jpl))


def test_packed_buckets_batch_size_bounds_rows(narrow):
    from shortseq_torch.count.ingest import packed_buckets
    from shortseq_torch.io.fastq import read_fastq_index

    data, starts, lengths = read_fastq_index(narrow[0])
    # Unpadded, as the sharded pipeline asks for them.
    whole = list(packed_buckets(data, starts, lengths, pad_pow2=False))
    parts = list(packed_buckets(data, starts, lengths, batch_size=37,
                                pad_pow2=False))
    assert all(len(l) <= 37 for _, l in parts) and len(parts) > len(whole)
    assert len(whole) == 2  # the 2- and 6-lane buckets
    for w, l in whole:
        mine = [p for p in parts if p[0].shape[1] == w.shape[1]]
        np.testing.assert_array_equal(np.concatenate([p[0] for p in mine]),
                                      w)
        np.testing.assert_array_equal(np.concatenate([p[1] for p in mine]),
                                      l)


def test_spills_identical_to_jax(narrow, tmp_path):
    path, _ = narrow
    ck_t, ck_j = tmp_path / "ck_torch", tmp_path / "ck_jax"
    tpl.count_fastq_sharded(path, n_shards=4, device="cpu",
                            config=PipelineConfig(checkpoint_dir=str(ck_t)))
    jpl.count_fastq_sharded(path, n_shards=4,
                            config=JaxConfig(checkpoint_dir=str(ck_j)))
    names = sorted(p.name for p in ck_j.iterdir())
    assert sorted(p.name for p in ck_t.iterdir()) == names
    assert len(names) == 5 and "manifest.json" in names
    assert json.loads((ck_t / "manifest.json").read_text()) == \
        json.loads((ck_j / "manifest.json").read_text())
    for s in range(4):
        got = tck.load_table(tck.shard_path(ck_t, 0, s))
        want = jck.load_table(jck.shard_path(ck_j, 0, s))
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_resume_across_packages(narrow, tmp_path, writer):
    """A directory half-written by one package, resumed by the other."""
    path, reads = narrow
    ck = tmp_path / "ck"
    if writer == "jax":
        jpl.count_fastq_sharded(path, n_shards=4,
                                config=JaxConfig(checkpoint_dir=str(ck)))
    else:
        tpl.count_fastq_sharded(path, n_shards=4, device="cpu",
                                config=PipelineConfig(checkpoint_dir=str(ck)))
    for s in (1, 3):
        jck.shard_path(ck, 0, s).unlink()
    if writer == "jax":
        got = tpl.count_fastq_sharded(
            path, n_shards=4, device="cpu",
            config=PipelineConfig(checkpoint_dir=str(ck)))
        want = jpl.count_fastq_sharded(path, n_shards=4)
    else:
        want = jpl.count_fastq_sharded(
            path, n_shards=4, config=JaxConfig(checkpoint_dir=str(ck)))
        got = tpl.count_fastq_sharded(path, n_shards=4, device="cpu")
    assert tck.completed_shards(ck, 0) == {0, 1, 2, 3}
    assert _as_dict(got) == dict(collections.Counter(reads))
    _same(_host(got, tpl), _host(want, jpl))


def test_partial_resume_recounts_only_missing(narrow, tmp_path,
                                              monkeypatch):
    path, reads = narrow
    ck = tmp_path / "ck_partial"
    cfg = PipelineConfig(checkpoint_dir=str(ck))
    tpl.count_fastq_sharded(path, n_shards=4, config=cfg, device="cpu")
    assert tck.completed_shards(ck, 0) == {0, 1, 2, 3}
    tck.shard_path(ck, 0, 2).unlink()
    saved = []
    real = tck.save_table
    monkeypatch.setattr(tck, "save_table",
                        lambda p, *a: saved.append(p) or real(p, *a))
    table = tpl.count_fastq_sharded(path, n_shards=4, config=cfg,
                                    device="cpu")
    assert saved == [tck.shard_path(ck, 0, 2)]
    assert _as_dict(table) == dict(collections.Counter(reads))


@pytest.mark.parametrize("size_mb", [0, 33])
def test_file_fingerprint_matches_jax(tmp_path, size_mb):
    path = tmp_path / "f.bin"
    rng = np.random.default_rng(size_mb)
    path.write_bytes(rng.integers(0, 256, size=(size_mb << 20) + 12345,
                                  dtype=np.uint8).tobytes())
    assert tck.file_fingerprint(path) == jck.file_fingerprint(path)
    assert tck.file_fingerprint(path, n_probes=3) == \
        jck.file_fingerprint(path, n_probes=3)


def test_manifest_refuses_incompatible_resume(narrow, tmp_path):
    path, _ = narrow
    ck = tmp_path / "ck"
    cfg = PipelineConfig(checkpoint_dir=str(ck))
    tpl.count_fastq_sharded(path, n_shards=3, config=cfg, device="cpu")
    with pytest.raises(ValueError, match="checkpoint dir"):
        tpl.count_fastq_sharded(path, n_shards=4, config=cfg, device="cpu")
    # Same size, one base changed: the fingerprint catches it.
    data = bytearray(open(path, "rb").read())
    i = data.index(b"\n") + 1
    data[i] = ord("A") if data[i] != ord("A") else ord("C")
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="checkpoint dir"):
        tpl.count_fastq_sharded(path, n_shards=3, config=cfg, device="cpu")
    # The JAX package refuses the port's manifest alike.
    with pytest.raises(ValueError, match="checkpoint dir"):
        jpl.count_fastq_sharded(path, n_shards=3,
                                config=JaxConfig(checkpoint_dir=str(ck)))


def test_tables_roundtrip_and_merge(tmp_path):
    from shortseq_torch.count.device import count_batch
    from shortseq_torch.ops.lanes import from_numpy_u32
    from shortseq_torch.oracle import blocks_to_lanes, encode_bytes

    import torch

    rng = np.random.default_rng(5)
    seqs_a = [ALPHA[rng.integers(0, 4, size=20)].tobytes().decode()
              for _ in range(40)]
    seqs_b = seqs_a[:10] + [ALPHA[rng.integers(0, 4, size=20)].tobytes()
                            .decode() for _ in range(30)]
    paths = []
    for i, seqs in enumerate([seqs_a, seqs_b]):
        words = np.array([blocks_to_lanes(encode_bytes(s.encode()), 2)
                          for s in seqs], np.uint32)
        table = count_batch(from_numpy_u32(words),
                            torch.full((len(seqs),), 20, dtype=torch.int32))
        p = tmp_path / f"t{i}.npz"
        tck.save_table(p, *table)
        w, l, c = tck.load_table(p)
        assert (w.dtype, l.dtype, c.dtype) == (np.uint32, np.int32, np.int32)
        assert len(l) == len(set(seqs))
        paths.append(p)
    merged = tck.merge_tables(paths, device="cpu")
    want = collections.Counter(seqs_a) + collections.Counter(seqs_b)
    assert _as_dict(merged) == dict(want)
    _same(_host(merged, tpl), _host(jck.merge_tables(paths), jpl))


def test_distributed_entry_single_process(mixed):
    from shortseq_torch.count.table import CountTable
    from shortseq_torch.dist import read_and_count_fastq_distributed
    from shortseq_tpu.count.table import CountTable as JaxCountTable

    path, reads = mixed
    table = read_and_count_fastq_distributed(path, device="cpu")
    assert table.layout == "prefix"
    assert _as_dict(table) == dict(collections.Counter(reads))
    lazy = CountTable.from_merged(table)
    want = JaxCountTable.from_merged(jpl.read_and_count_fastq_distributed(
        path))
    assert len(lazy) == len(want) == len(set(reads))
    assert lazy.total() == want.total() == len(reads)
    assert [(str(k), c) for k, c in lazy.most_common()] == \
        [(str(k), c) for k, c in want.most_common()]
    assert tpl.table_to_host_rows(table) == \
        jpl.table_to_host_rows(jpl.count_fastq_sharded(path))


def test_entry_points_default_to_the_card(narrow, tmp_path):
    """The sharded and distributed entry points default to device="cuda"
    and raise without a card, before any process group starts."""
    import torch
    import torch.distributed as dist

    from shortseq_torch.dist import data_mesh, initialize_distributed

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works there")
    path, _ = narrow
    for call in (lambda: tpl.count_fastq_sharded(path),
                 lambda: tpl.read_and_count_fastq_distributed(path),
                 lambda: data_mesh(),
                 lambda: initialize_distributed(
                     init_method=f"file://{tmp_path / 'pg'}", rank=0,
                     world_size=1)):
        with pytest.raises(RuntimeError, match="device='cuda'"):
            call()
    assert not dist.is_initialized()


def test_table_to_host_raises_on_overflow_and_poison():
    import torch

    w = torch.zeros((2, 2), dtype=torch.int32)
    l = torch.tensor([4, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="n_out too small"):
        tpl._table_to_host((w, l, torch.ones(2, dtype=torch.int32),
                            torch.tensor(3)))
    with pytest.raises(OverflowError, match="int32"):
        tpl._table_to_host((w, l, torch.tensor([2, -1], dtype=torch.int32),
                            torch.tensor(2)))
    with pytest.raises(ValueError, match="n_out too small"):
        tpl._table_to_host((w.numpy(), l.numpy(), np.ones(2, np.int32), 3))


_CRASH_SCRIPT = r"""
import os, sys
for name in ("jax", "jaxlib", "shortseq_tpu"):
    sys.modules[name] = None
import shortseq_torch.count.checkpoint as ckpt

real_save = ckpt.save_table
calls = {"n": 0}
def dying_save(*a, **k):
    real_save(*a, **k)
    calls["n"] += 1
    if calls["n"] >= int(sys.argv[3]):
        os._exit(17)  # hard crash: no atexit, no finally blocks
ckpt.save_table = dying_save

from shortseq_torch.config import PipelineConfig
from shortseq_torch.dist.pipeline import count_fastq_sharded
count_fastq_sharded(sys.argv[1], n_shards=4, device="cpu",
                    config=PipelineConfig(checkpoint_dir=sys.argv[2]))
print("UNEXPECTED: completed without crashing")
sys.exit(1)
"""

_RESUME_SCRIPT = r"""
import json, sys
for name in ("jax", "jaxlib", "shortseq_tpu"):
    sys.modules[name] = None
import shortseq_torch.count.checkpoint as ckpt

recounted = []
real_save = ckpt.save_table
def counting_save(path, *a, **k):
    recounted.append(str(path))
    real_save(path, *a, **k)
ckpt.save_table = counting_save

from shortseq_torch.config import PipelineConfig
from shortseq_torch.dist.pipeline import count_fastq_sharded, table_to_counter
counts = table_to_counter(count_fastq_sharded(
    sys.argv[1], n_shards=4, device="cpu",
    config=PipelineConfig(checkpoint_dir=sys.argv[2])))
print(json.dumps({"counts": {str(k): v for k, v in counts.items()},
                  "recounted": len(recounted)}))
"""


def test_mid_run_crash_then_resume(tmp_path):
    rng = np.random.default_rng(0xDEAD)
    pool = [ALPHA[rng.integers(0, 4, size=int(k))].tobytes().decode()
            for k in rng.integers(8, 31, size=10)]
    reads = [pool[i] for i in rng.integers(0, 10, size=240)]
    fq = _write(tmp_path / "r.fastq", reads)
    ckpt_dir = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    crash = subprocess.run(
        [sys.executable, "-c", _CRASH_SCRIPT, fq, str(ckpt_dir), "2"],
        env=env, capture_output=True, text=True, timeout=120)
    assert crash.returncode == 17, (crash.returncode, crash.stderr[-2000:])
    assert len(list(ckpt_dir.glob("counts_*.npz"))) == 2
    resume = subprocess.run(
        [sys.executable, "-c", _RESUME_SCRIPT, fq, str(ckpt_dir)],
        env=env, capture_output=True, text=True, timeout=120)
    assert resume.returncode == 0, resume.stderr[-2000:]
    out = json.loads(resume.stdout.strip().splitlines()[-1])
    assert out["recounted"] == 2
    assert out["counts"] == dict(collections.Counter(reads))
