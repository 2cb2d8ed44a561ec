"""shortseq_torch's sharded UMI dedup (dist/umi.py, `mesh=` on
dedup_umis / dedup_reads / _neighbor_lists) across processes: gloo on the
CPU at world sizes 2 and 3, in the style of tests/test_torch_dist.py.

Each rank is a subprocess that never imports jax: it joins a file://
process group (a 120 s timeout on the group, 150 s on the subprocess, so
a hung collective fails instead of stalling the suite), runs every case
with `mesh=` on the same seeded inputs, and writes what it saw to a JSON
file.  The parent computes the JAX package's single-device results once
and checks that every rank's equal them, row for row and label for label
(the inputs of tests/test_multichip.py's sharded UMI script):

  (a) _neighbor_lists on 400 unique 10-nt UMIs;
  (b) dedup_umis at (seed, method, threshold) (21, directional, 1),
      (22, cluster, 1), (23, adjacency, 1), (24, directional, 2);
  (c) dedup_reads(len_5p=10) on a list and on an [N, L] uint8 matrix;
  (d) ragged UMIs of 8-12 nt;
  (e) 300 unique UMIs with _block=256: bands of 256 / 44 rows at world
      2 and 256 / 44 / 0 at world 3;
  (f) error fans at threshold 2, whose rows go over k = 16 (the
      overflow tier);
  (g) every rank returns the same results;
  (h) ranks that pass different UMI counts raise ValueError on every
      rank.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import shortseq_torch.umi.dedup as td
from chip_smoke import csr_rows, fan_umis
from shortseq_torch import dist as sd
from tests.conftest import REPO_ROOT

ALPHA = np.frombuffer(b"ACGT", np.uint8)
DEDUP_CASES = [(21, "directional", 1), (22, "cluster", 1),
               (23, "adjacency", 1), (24, "directional", 2)]


def pool_umis(seed):
    """tests/test_multichip.py's draw: 3000 UMIs from a pool of 400 random
    10-mers, and the generator, for the reads drawn after them."""
    rng = np.random.default_rng(seed)
    pool = ALPHA[rng.integers(0, 4, size=(400, 10))]
    return [pool[i].tobytes() for i in rng.integers(0, 400, size=3000)], \
        pool, rng


def umi_reads():
    """2000 reads of a 10-nt UMI from pool 21 and one 16-nt insert."""
    _, pool, rng = pool_umis(21)
    return [pool[i].tobytes() + b"ACGTACGTACGTACGT"
            for i in rng.integers(0, 400, size=2000)]


def ragged_umis(seed=31, n=1500):
    """UMIs of 8-12 nt from a pool of 40 a length, 30% of them with one
    substitution."""
    rng = np.random.default_rng(seed)
    pools = {n_nt: ALPHA[rng.integers(0, 4, size=(40, n_nt))]
             for n_nt in range(8, 13)}
    out = []
    for n_nt in rng.integers(8, 13, size=n):
        u = pools[n_nt][rng.integers(0, 40)].copy()
        if rng.random() < 0.3:
            u[rng.integers(0, n_nt)] = ALPHA[rng.integers(0, 4)]
        out.append(u.tobytes())
    return out


def umis_300():
    """Exactly 300 unique 8-nt UMIs (150 random, 150 one substitution from
    one of them), each twice, the first 100 three times."""
    rng = np.random.default_rng(41)
    base = [ALPHA[rng.integers(0, 4, size=8)].tobytes() for _ in range(150)]
    uniq = list(dict.fromkeys(base))
    while len(uniq) < 300:
        u = np.frombuffer(uniq[rng.integers(0, 150)], np.uint8).copy()
        u[rng.integers(0, 8)] = ALPHA[rng.integers(0, 4)]
        uniq = list(dict.fromkeys(uniq + [u.tobytes()]))
    return uniq * 2 + uniq[:100]


def fans():
    return fan_umis(8, 12, seed=5)


def packed(uniq):
    """The UMIs `uniq` packed by the port on the CPU: ([U, W] words, [U]
    int32 lengths)."""
    mat, lengths = td._padded_rows(uniq)
    lengths = lengths.astype(np.int32)
    return td._pack_validate_matrix(mat, lengths, "cpu"), lengths


_WORKER = r"""
import json, sys
for name in ("jax", "jaxlib", "shortseq_tpu"):
    sys.modules[name] = None
import numpy as np
import shortseq_torch.umi.dedup as td
from shortseq_torch import dist as sd
from tests import test_torch_dist_umi as cases

rank, world = int(sys.argv[1]), int(sys.argv[2])
init, out = sys.argv[3:5]
sd.initialize_distributed(init_method=init, rank=rank, world_size=world,
                          device="cpu", timeout=120)
mesh = sd.data_mesh(device="cpu")
res = {"rank": mesh.rank, "size": mesh.size}


def dedup(fn, *args, **kwargs):
    labels, reps = fn(*args, mesh=mesh, **kwargs)
    return {"labels": labels.tolist(),
            "reps": [r.decode() if isinstance(r, bytes)
                     else [x.decode() for x in r] for r in reps]}


umis, _, _ = cases.pool_umis(21)
uniq = sorted(set(umis))
words, lengths = cases.packed(uniq)
res["lists"] = [x.tolist() for x in
                cases.csr_rows(td._neighbor_lists(words, lengths, 1,
                                                  mesh=mesh))]
for seed, method, thr in cases.DEDUP_CASES:
    res[f"umis_{seed}"] = dedup(td.dedup_umis, cases.pool_umis(seed)[0],
                                threshold=thr, method=method)
reads = cases.umi_reads()
res["reads_list"] = dedup(td.dedup_reads, reads, len_5p=10)
mat = np.frombuffer(b"".join(reads), np.uint8).reshape(len(reads), -1)
res["reads_matrix"] = dedup(td.dedup_reads, mat, len_5p=10)
res["ragged"] = dedup(td.dedup_umis, cases.ragged_umis())

# This rank's band: the rows kernel H (its plain version here) was given.
bands, real_h = [], td.neighbor_lists_fused
td.neighbor_lists_fused = lambda a, *r: bands.append(len(a)) or real_h(a, *r)
res["u300"] = dedup(td.dedup_umis, cases.umis_300(), _block=256)
td.neighbor_lists_fused = real_h
res["band"] = bands

# The overflow tier: kernel C's calls (its plain version here).
calls, real_c = [], td.neighbor_extract
td.neighbor_extract = lambda *a, **k: calls.append(1) or real_c(*a, **k)
res["fans"] = dedup(td.dedup_umis, cases.fans(), threshold=2)
td.neighbor_extract = real_c
res["overflow_calls"] = len(calls)

# Ranks that disagree on the UMIs raise on every rank (no hang).
try:
    td.dedup_umis(uniq[:200 + rank], mesh=mesh)
    res["mismatch"] = "no error"
except ValueError as e:
    res["mismatch"] = str(e)
import torch
torch.distributed.destroy_process_group()
with open(out, "w") as f:
    json.dump(res, f)
"""


def _as_json(labels, reps):
    return {"labels": np.asarray(labels).tolist(),
            "reps": [r.decode() if isinstance(r, bytes)
                     else [x.decode() for x in r] for r in reps]}


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's single-device results of every case (imported
    here: the ranks import this module's inputs with jax blocked)."""
    import shortseq_tpu.umi.dedup as jd

    umis, _, _ = pool_umis(21)
    uniq = sorted(set(umis))
    words, lengths = jd._pack_validate_umis(uniq)
    out = {"lists": [np.asarray(x).tolist() for x in
                     jd._neighbor_lists(np.asarray(words), lengths, 1)]}
    for seed, method, thr in DEDUP_CASES:
        out[f"umis_{seed}"] = _as_json(*jd.dedup_umis(
            pool_umis(seed)[0], threshold=thr, method=method))
    reads = umi_reads()
    out["reads_list"] = _as_json(*jd.dedup_reads(reads, len_5p=10))
    mat = np.frombuffer(b"".join(reads), np.uint8).reshape(len(reads), -1)
    out["reads_matrix"] = _as_json(*jd.dedup_reads(mat, len_5p=10))
    out["ragged"] = _as_json(*jd.dedup_umis(ragged_umis()))
    out["u300"] = _as_json(*jd.dedup_umis(umis_300(), _block=256))
    out["fans"] = _as_json(*jd.dedup_umis(fans(), threshold=2))
    return out


@pytest.fixture(scope="module", params=[2, 3], ids=["world2", "world3"])
def world_run(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"gloo_umi{world}")
    outs = [tmp / f"rank{r}.json" for r in range(world)]
    env = dict(os.environ, PYTHONPATH=REPO_ROOT)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world),
         f"file://{tmp / 'pg_init'}", str(outs[r])], cwd=REPO_ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
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
    return world, results


def test_neighbor_lists_match_jax_row_for_row(world_run, jax_results):
    _, results = world_run
    want = jax_results["lists"]
    assert sum(map(len, want)) > 0
    for r in results:
        assert r["lists"] == want


@pytest.mark.parametrize("seed, method, threshold", DEDUP_CASES)
def test_dedup_umis_matches_jax(world_run, jax_results, seed, method,
                                threshold):
    _, results = world_run
    want = jax_results[f"umis_{seed}"]
    assert len(want["reps"]) < len(set(pool_umis(seed)[0]))  # merges
    for r in results:
        assert r[f"umis_{seed}"] == want


@pytest.mark.parametrize("form", ["list", "matrix"])
def test_dedup_reads_matches_jax(world_run, jax_results, form):
    _, results = world_run
    for r in results:
        assert r[f"reads_{form}"] == jax_results[f"reads_{form}"]


def test_ragged_umis_match_jax(world_run, jax_results):
    _, results = world_run
    for r in results:
        assert r["ragged"] == jax_results["ragged"]


def test_bands_and_empty_band_match_jax(world_run, jax_results):
    world, results = world_run
    want = [256, 44, 0][:world]
    assert [r["band"] for r in results] == [[b] for b in want]
    for r in results:
        assert r["u300"] == jax_results["u300"]


def test_overflow_tier_matches_jax(world_run, jax_results):
    _, results = world_run
    for r in results:
        assert r["overflow_calls"] > 0
        assert r["fans"] == jax_results["fans"]


def test_every_rank_returns_the_same(world_run):
    _, results = world_run
    keys = set(results[0]) - {"rank", "band"}
    for r in results[1:]:
        assert {k: r[k] for k in keys} == {k: results[0][k] for k in keys}


def test_mismatched_ranks_raise_on_every_rank(world_run):
    world, results = world_run
    for r in results:
        assert r["mismatch"].startswith("ranks disagree on the UMI problem")
        assert f"[{199 + world}, " in r["mismatch"]


@pytest.mark.parametrize("case", ["umis", "reads", "lists"])
def test_mesh_of_one_equals_no_mesh(case):
    """data_mesh with no process group: a mesh of this process alone."""
    mesh = sd.data_mesh(device="cpu")
    assert not mesh.distributed and mesh.size == 1
    if case == "umis":
        args, fn = (fans(),), td.dedup_umis
        kwargs = {"threshold": 2}
    elif case == "reads":
        args, fn, kwargs = (umi_reads(),), td.dedup_reads, {"len_5p": 10}
    else:
        uniq = sorted(set(pool_umis(21)[0]))
        words, lengths = packed(uniq)
        got = csr_rows(td._neighbor_lists(words, lengths, 1, mesh=mesh))
        want = csr_rows(td._neighbor_lists(words, lengths, 1, device="cpu"))
        assert [x.tolist() for x in got] == [x.tolist() for x in want]
        return
    got = fn(*args, mesh=mesh, **kwargs)
    want = fn(*args, device="cpu", **kwargs)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_mesh_device_rules():
    mesh = sd.data_mesh(device="cpu")
    umis = [b"AAAA", b"AAAA", b"AAAT", b"CCCC"]
    got = td.dedup_umis(umis, mesh=mesh, device="cpu")
    assert got[0].tolist() == [0, 0, 0, 1] and got[1] == [b"AAAA", b"CCCC"]
    with pytest.raises(ValueError, match="not the mesh's device"):
        td.dedup_umis([b"AAAA", b"AAAT"], mesh=mesh, device="cuda")
    with pytest.raises(ValueError, match="not the mesh's device"):
        td.dedup_reads([b"AAAACGT"], len_5p=4, mesh=mesh, device="cuda:1")


def test_step_alone_and_its_padding_check():
    """The step on padded operands equals the single-device lists; padded
    rows not a multiple of ranks x block raise."""
    import torch

    mesh = sd.data_mesh(device="cpu")
    uniq = sorted(set(pool_umis(21)[0]))
    words, lengths = packed(uniq)
    u = len(uniq)
    w = torch.zeros((512, 2), dtype=torch.int32)
    w[:u] = words
    ln = torch.full((512,), -1, dtype=torch.int32)
    ln[:u] = torch.from_numpy(lengths)
    gids = torch.zeros(512, dtype=torch.int32)
    idx, cnt = sd.neighbors_sharded_step(mesh, 1, 16, 256)(w, ln, gids, u)
    assert idx.shape == (u, 16) and cnt.shape == (u,)
    want = csr_rows(td._neighbor_lists(words, lengths, 1, block=256,
                                       device="cpu"))
    assert [r[r < 512].tolist() for r in idx] == [x.tolist() for x in want]
    assert cnt.tolist() == [len(x) for x in want]
    with pytest.raises(ValueError, match="multiple of 1 ranks x block 384"):
        sd.neighbors_sharded_step(mesh, 1, 16, 384)(w, ln, gids, u)
