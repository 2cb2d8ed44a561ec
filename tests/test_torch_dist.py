"""shortseq_torch.dist across processes: torch.distributed with gloo on the
CPU at world size 2 and 3, in the style of tests/test_multihost.py.

Each rank is a subprocess that never imports jax: it joins a file://
process group (a 120 s timeout on the group and on the subprocess, so a
hung collective fails instead of stalling the suite), runs the entry
points on its share of the same seeded data, and writes what it saw to a
JSON file.  The parent checks that every rank saw the same thing and that
it equals collections.Counter and the JAX package's single-process count:

  * read_and_count_fastq_distributed on a FASTQ whose per-rank tables
    differ in rows and lane width (the max-rows / max-width padding);
  * make_sharded_counter on ASCII rows: a benign batch stays "scattered"
    (tier 1), one dominant key takes tier 2, distinct keys that all hash
    to one bucket go to "prefix" (tier 3); the validity mask comes back in
    rank order;
  * DistributedCountTable's reads against a CountTable of all the rows;
  * ranks that disagree on the shard shape raise on every rank.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.conftest import REPO_ROOT

ALPHA = np.frombuffer(b"ACGT", np.uint8)
WIDTH = 48          # ASCII columns of the row matrices (3 packed lanes)
ROWS_PER_RANK = 240

_WORKER = r"""
import json, sys
for name in ("jax", "jaxlib", "shortseq_tpu"):
    sys.modules[name] = None
import numpy as np, torch
from shortseq_torch import dist as sd
from shortseq_torch.count.device import unique_count
from shortseq_torch.count.table import CountTable
from shortseq_torch.dist import count as dc
from shortseq_torch.ops.bitpack import pack_and_validate_u32

rank, world = int(sys.argv[1]), int(sys.argv[2])
init, fastq, rows_path, out = sys.argv[3:7]
sd.initialize_distributed(init_method=init, rank=rank, world_size=world,
                          device="cpu", timeout=120)
sd.initialize_distributed(init_method=init, rank=rank, world_size=world,
                          device="cpu")  # idempotent
mesh = sd.data_mesh(device="cpu")
res = {"rank": mesh.rank, "size": mesh.size}
rows = np.load(rows_path)


def as_dict(table):
    return {str(k): v for k, v in sd.table_to_counter(table).items()}


def tiers_of(fn):
    before = dict(dc.count_sharded_auto.tiers)
    out = fn()
    return out, [t for t, n in dc.count_sharded_auto.tiers.items()
                 if n != before[t]]


table, tiers = tiers_of(lambda: sd.read_and_count_fastq_distributed(
    fastq, n_shards=5, device="cpu"))
res["fastq"] = {"layout": table.layout, "tiers": tiers,
                "n_unique": int(table.n_unique), "table": as_dict(table)}

k = len(rows["zipf_len"]) // world
mine = slice(rank * k, (rank + 1) * k)
for name, factor in (("zipf", 2.0), ("dups", 1.0), ("skew", 0.5)):
    step = dc.make_sharded_counter(mesh, capacity_factor=factor)
    (table, ok), tiers = tiers_of(lambda: step(rows[name][mine],
                                               rows[name + "_len"][mine]))
    res[name] = {"layout": table.layout, "tiers": tiers,
                 "table": as_dict(table), "ok": ok.tolist()}
    if name == "zipf":
        zipf = table
bad = rows["zipf"].copy()
bad[int(rows["bad_row"]), 2] = ord("N")
_, ok = dc.make_sharded_counter(mesh)(bad[mine], rows["zipf_len"][mine])
res["bad_ok"] = ok.tolist()

# The replicated merges: the bucketed exchange with replicate=True (live
# rows compacted to a prefix) and count_sharded (all_gather + re-count).
x = torch.from_numpy(rows["zipf"][mine]).view(torch.int32)
lens = torch.from_numpy(rows["zipf_len"][mine])
words, _ = pack_and_validate_u32(x, lens)
ones = torch.ones(len(lens), dtype=torch.int32)
w_, l_, c_, n_, over = dc.count_sharded_bucketed(mesh)(words, lens, ones)
prefix = (l_[:int(n_)] != dc.PAD_LENGTH).all() and \
    (l_[int(n_):] == dc.PAD_LENGTH).all()
res["replicated"] = {"table": as_dict((w_, l_, c_, n_)),
                     "overflow": int(over), "prefix": bool(prefix)}
res["gathered"] = as_dict(dc.count_sharded(mesh)(words, lens, ones))

# Bands of different lengths, gathered in rank order.
band = torch.arange(10 * rank, 10 * rank + 3 + rank).reshape(-1, 1)
res["bands"] = sd.pipeline.gather_row_sharded(band, mesh).ravel().tolist()

# DistributedCountTable on the scattered zipf table against a CountTable
# of every rank's rows counted in one process.
x = torch.from_numpy(rows["zipf"]).view(torch.int32)
lens = torch.from_numpy(rows["zipf_len"])
words, _ = pack_and_validate_u32(x, lens)
want = CountTable.from_device_tables([unique_count(
    words, lens, torch.ones(len(lens), dtype=torch.int32))])
got = sd.distributed_count_table(zipf, mesh)
keys = [str(k) for k, _ in want.most_common(3)]
probes = keys + ["ACGTACGTACGTACGTAAAAAAAAAAAA", "ACGN", "", b"A" * 200]


def reads(t):
    out = {"len": len(t), "total": t.total(),
           "values": sorted(int(v) for v in t.values()),
           "get": [t.get(p, -7) for p in probes],
           "contains": [p in t for p in probes],
           "getitem": [t[p] for p in keys],
           "counter": {str(k): v for k, v in t.to_counter().items()}}
    for n in (1, 5, 20, None):
        out[f"top{n}"] = [(str(k), c) for k, c in t.most_common(n)]
    try:
        t["ACGTACGTACGTACGTAAAAAAAAAAAA"]
        out["missing"] = "no KeyError"
    except KeyError:
        out["missing"] = "KeyError"
    return out


res["reads"] = {"type": type(got).__name__, "got": reads(got),
                "want": reads(want)}

# Ranks that disagree on the shape raise on every rank (no hang).
n = 10 + rank
try:
    dc.count_sharded_auto(mesh)(words[:n], lens[:n],
                                torch.ones(n, dtype=torch.int32))
    res["mismatch"] = "no error"
except ValueError as e:
    res["mismatch"] = str(e)
torch.distributed.destroy_process_group()
with open(out, "w") as f:
    json.dump(res, f)
"""


def _pack(mat, lens):
    from shortseq_torch.ops.bitpack import pack_and_validate_u32

    words, ok = pack_and_validate_u32(torch.from_numpy(mat).view(torch.int32),
                                      torch.from_numpy(lens))
    assert bool(ok.all())
    return words


def _matrix(reads):
    mat = np.zeros((len(reads), WIDTH), np.uint8)
    for i, r in enumerate(reads):
        mat[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    return mat, np.array([len(r) for r in reads], np.int32)


def _rand_reads(rng, n, lo=12, hi=WIDTH):
    return [ALPHA[rng.integers(0, 4, size=int(k))].tobytes().decode()
            for k in rng.integers(lo, hi + 1, size=n)]


def _row_sets(world):
    """The rows of the make_sharded_counter runs, all ranks' rows in rank
    order: zipf (20 keys of counts 22..3, then singletons; shuffled),
    dups (70% one key), skew (distinct keys that all hash to bucket 0 of
    `world`), and the global index of the row given an invalid base."""
    from shortseq_torch.dist.count import _bucket_hash

    rng = np.random.default_rng(world)
    n = ROWS_PER_RANK * world
    top = _rand_reads(rng, 20)
    zipf = [r for i, r in enumerate(top) for _ in range(22 - i)]
    zipf += _rand_reads(rng, n - len(zipf), lo=30)
    zipf = [zipf[i] for i in rng.permutation(n)]
    dom = _rand_reads(rng, 1)[0]
    dups = [dom if rng.random() < 0.7 else r for r in _rand_reads(rng, n)]
    skew = []
    while len(skew) < n:
        cand = sorted(set(_rand_reads(rng, 4096, lo=20, hi=20)) - set(skew))
        mat, lens = _matrix(cand)
        b = _bucket_hash(_pack(mat, lens), torch.from_numpy(lens), world)
        skew += [c for c, hit in zip(cand, (b == 0).tolist()) if hit]
    skew = skew[:n]
    out = {"bad_row": np.int64(rng.integers(0, n))}
    for name, reads in (("zipf", zipf), ("dups", dups), ("skew", skew)):
        out[name], out[name + "_len"] = _matrix(reads)
    return out, {"zipf": zipf, "dups": dups, "skew": skew}


def _write_fastq(path, rng):
    """Reads from a pool that straddles the 32/96-nt width classes, with
    uneven headers, so each rank's table differs in rows and lanes."""
    pool = _rand_reads(rng, 14, lo=8, hi=32) + _rand_reads(rng, 6, lo=33,
                                                            hi=96)
    reads = [pool[i] for i in rng.integers(0, len(pool), size=400)]
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@read_{i}_{'x' * int(rng.integers(0, 40))}\n{r}\n+\n"
                    f"{'I' * len(r)}\n")
    return reads


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world_run(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gloo{world}")
    fastq = tmp / "reads.fastq"
    reads = _write_fastq(fastq, np.random.default_rng(100 + world))
    arrays, row_reads = _row_sets(world)
    np.savez(tmp / "rows.npz", **arrays)
    outs = [tmp / f"rank{r}.json" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         f"file://{tmp / 'pg_init'}", str(fastq), str(tmp / "rows.npz"),
         str(outs[r])], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=150)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, err) in enumerate(zip(procs, errs)):
        assert p.returncode == 0, f"rank {r}: {err[-3000:]}"
    results = [json.loads(o.read_text()) for o in outs]
    assert [r["rank"] for r in results] == list(range(world))
    assert all(r["size"] == world for r in results)
    return world, fastq, reads, row_reads, arrays, results


def test_fastq_count_identical_on_every_rank(world_run):
    import shortseq_tpu.dist.pipeline as jpl

    world, fastq, reads, _, _, results = world_run
    first = results[0]["fastq"]
    assert all(r["fastq"] == first for r in results)
    assert first["table"] == dict(collections.Counter(reads))
    assert first["n_unique"] == len(set(reads))
    assert first["layout"] == "scattered" and first["tiers"] == [1]
    want = jpl.table_to_counter(jpl.count_fastq_sharded(str(fastq)))
    assert first["table"] == {str(k): v for k, v in want.items()}


@pytest.mark.parametrize("name, layout, tier", [
    ("zipf", "scattered", 1), ("dups", "scattered", 2), ("skew", "prefix", 3)])
def test_tier_agrees_on_every_rank(world_run, name, layout, tier):
    _, _, _, row_reads, _, results = world_run
    first = results[0][name]
    assert all(r[name] == first for r in results)
    assert (first["layout"], first["tiers"]) == (layout, [tier])
    assert first["table"] == dict(collections.Counter(row_reads[name]))
    assert all(first["ok"])
    assert len(first["ok"]) == len(row_reads[name])


def test_replicated_merges_identical_on_every_rank(world_run):
    _, _, _, row_reads, _, results = world_run
    want = dict(collections.Counter(row_reads["zipf"]))
    for r in results:
        assert r["replicated"] == {"table": want, "overflow": 0,
                                   "prefix": True}
        assert r["gathered"] == want


def test_gather_row_sharded_in_rank_order(world_run):
    world, _, _, _, _, results = world_run
    want = [v for r in range(world) for v in range(10 * r, 10 * r + 3 + r)]
    assert all(r["bands"] == want for r in results)


def test_validity_mask_in_rank_order(world_run):
    _, _, _, _, arrays, results = world_run
    for r in results:
        assert np.flatnonzero(~np.asarray(r["bad_ok"])).tolist() == \
            [int(arrays["bad_row"])]


def test_distributed_table_reads_equal_count_table(world_run):
    _, _, _, row_reads, _, results = world_run
    first = results[0]["reads"]
    assert first["type"] == "DistributedCountTable"
    assert all(r["reads"] == first for r in results)
    assert first["got"] == first["want"]
    want = collections.Counter(row_reads["zipf"])
    assert first["got"]["counter"] == dict(want)
    top = sorted(want.items(), key=lambda kv: (-kv[1], kv[0]))
    assert [tuple(kv) for kv in first["got"]["topNone"]] == top
    assert [tuple(kv) for kv in first["got"]["top5"]] == top[:5]
    assert first["got"]["missing"] == "KeyError"


def test_shape_mismatch_raises_on_every_rank(world_run):
    world, _, _, _, _, results = world_run
    for r in results:
        assert r["mismatch"].startswith("ranks disagree on the shard shape")
        assert f"rows 10..{9 + world}" in r["mismatch"]
