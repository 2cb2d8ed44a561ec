"""K10, the bucketed exchange's bucket ids and send buffers
(shortseq_torch/dist/count.py, kernel csrc/dist.cu), against
shortseq_tpu/dist/count.py.

On the CPU the wrapper takes its plain version.  Each rank's send buffers,
an in-process exchange (rank d takes chunk d of every rank's buffers, in
rank order) and the port's unique_count must give exactly slab d of the
JAX package's count_sharded_bucketed(replicate=False) over a D-device CPU
mesh, overflow flag included; at one rank also on file 2's 64-lane rows,
which both packages order by the row hash.  The kernel's own cases (tile
edges, PAD rows, the capacity edge, N = 0, a grown tile) run on the card
and skip here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shortseq_torch.dist.count as tdc
from shortseq_torch.count.device import PAD_LENGTH, unique_count
from shortseq_torch.ops.lanes import from_numpy_u32
from shortseq_tpu.dist.count import _bucket_hash as jax_bucket_hash
from shortseq_tpu.dist.count import count_sharded_bucketed as jax_bucketed
from shortseq_tpu.dist.mesh import data_mesh as jax_mesh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _rows(seed, n, w, pad_every=0):
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64) \
        .astype(np.uint32)
    lengths = rng.integers(0, 16 * w + 1, size=n).astype(np.int32)
    if pad_every:
        lengths[::pad_every] = PAD_LENGTH
    return words, lengths


def _t(words, lengths, weights=None):
    if weights is None:
        weights = np.ones(len(lengths), np.int32)
    return (from_numpy_u32(words), torch.from_numpy(lengths.copy()),
            torch.from_numpy(np.asarray(weights, np.int32).copy()))


def _one_bucket_keys(seed, n, d, w=2, length=20):
    """n distinct keys whose rows all hash to bucket 0 of d."""
    rng = np.random.default_rng(seed)
    keys = []
    while len(keys) < n:
        cand = rng.integers(0, 2**32, size=(8192, w), dtype=np.uint64) \
            .astype(np.uint32)
        b = tdc._bucket_hash(from_numpy_u32(cand),
                             torch.full((8192,), length, dtype=torch.int32),
                             d).numpy()
        keys.extend(map(tuple, cand[b == 0]))
    return np.asarray(sorted(set(keys))[:n], np.uint32)


@pytest.mark.parametrize("d", [1, 2, 3, 6, 8, 65536])
@pytest.mark.parametrize("w", [1, 2, 6, 64])
def test_bucket_hash_matches_jax(d, w):
    words, lengths = _rows(d + w, 3000, w, pad_every=5)
    want = np.asarray(jax_bucket_hash(jnp.asarray(words),
                                      jnp.asarray(lengths), d))
    got = tdc._bucket_hash(*_t(words, lengths)[:2], d)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert got.min() >= 0 and got.max() < d


@pytest.mark.parametrize("d", [0, 65537, -1])
def test_bucket_count_out_of_range_rejected(d):
    words, lengths, weights = _t(*_rows(0, 8, 2))
    with pytest.raises(ValueError, match="n_buckets"):
        tdc._bucket_hash(words, lengths, d)
    with pytest.raises(ValueError, match="n_buckets"):
        tdc.bucket_send_buffers(words, lengths, weights, d, 8)
    with pytest.raises(ValueError, match="n_buckets"):
        jax_bucket_hash(jnp.zeros((4, 2), jnp.uint32),
                        jnp.zeros(4, jnp.int32), d)


def test_bucket_hash_uniform_loads():
    """tests/test_multichip.py's load spread, on the port's hash: near
    uniform for every D, not only powers of two."""
    rng = np.random.default_rng(3)
    n = 100_000
    words = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64) \
        .astype(np.uint32)
    lengths = rng.integers(8, 33, size=n).astype(np.int32)
    for d in (2, 3, 5, 6, 8, 12):
        loads = np.bincount(tdc._bucket_hash(*_t(words, lengths)[:2], d)
                            .numpy(), minlength=d)
        mean = n / d
        assert loads.max() < 1.15 * mean, (d, loads.tolist())
        assert loads.min() > 0.85 * mean, (d, loads.tolist())


def _reference_send(words, lengths, weights, d, cap):
    """A loop over the rows in order: the independent statement of the
    send buffers (per-bucket running ranks)."""
    n, w = words.shape
    out_w = np.zeros((d * cap, w), np.uint32)
    out_l = np.full(d * cap, PAD_LENGTH, np.int32)
    out_c = np.zeros(d * cap, np.int32)
    bucket = np.asarray(jax_bucket_hash(jnp.asarray(words),
                                        jnp.asarray(lengths), d))
    seen = [0] * d
    overflow = 0
    for i in range(n):
        if lengths[i] == PAD_LENGTH:
            continue
        b = int(bucket[i])
        r = seen[b]
        seen[b] += 1
        if r >= cap:
            overflow = 1
            continue
        out_w[b * cap + r] = words[i]
        out_l[b * cap + r] = lengths[i]
        out_c[b * cap + r] = weights[i]
    return out_w, out_l, out_c, overflow


@pytest.mark.parametrize("case", ["benign", "pads", "edge_fits",
                                  "edge_overflows", "empty"])
@pytest.mark.parametrize("d", [1, 3, 6])
def test_plain_send_buffers_match_loop(case, d):
    rng = np.random.default_rng(d)
    if case in ("edge_fits", "edge_overflows"):
        # Every row in bucket 0; cap rows exactly fit, cap + 1 overflow.
        keys = _one_bucket_keys(d, 40, d)
        words = keys[rng.integers(0, 40, size=50)]
        lengths = np.full(50, 20, np.int32)
        cap = 50 if case == "edge_fits" else 49
    elif case == "empty":
        words, lengths, cap = np.zeros((0, 2), np.uint32), \
            np.zeros(0, np.int32), 0
    else:
        words, lengths = _rows(d, 500, 2, pad_every=3 if case == "pads"
                               else 0)
        cap = tdc.bucket_capacity(500, d, 2.0)
    weights = rng.integers(1, 9, size=len(lengths)).astype(np.int32)
    got = tdc.bucket_send_buffers(*_t(words, lengths, weights), d, cap)
    want = _reference_send(words, lengths, weights, d, cap)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert int(got[3]) == want[3] == (case == "edge_overflows")
    assert got[3].dtype == torch.int32 and got[3].dim() == 0


def _rows_150nt(seed, n, keys):
    """File 2's layout at a small n: 150-nt reads in the 64-lane bucket
    (lanes past 10 zero), drawn from `keys` distinct keys (n: all
    distinct)."""
    rng = np.random.default_rng(seed)
    pool = np.zeros((keys, 64), np.uint32)
    pool[:, :10] = rng.integers(0, 2**32, size=(keys, 10), dtype=np.uint64)
    pool[:, 9] &= 0x3FFFFF          # 150 nt: 6 codes in the last lane
    words = pool[rng.integers(0, keys, size=n)] if keys < n else pool
    return np.ascontiguousarray(words), np.full(n, 150, np.int32)


@pytest.mark.parametrize("pre_dedup", [False, True])
@pytest.mark.parametrize("keys", [60, 400])
def test_plain_send_buffers_w64_one_rank_match_jax(keys, pre_dedup):
    """What the main path gives K10 at one rank on file 2's words: W = 64,
    D = 1, capacity factor 0.25, raw (tier 1) or pre-deduped (tier 2).
    The send buffers equal the loop over JAX's hash exactly (pre-deduped
    rows taken from JAX's unique_count, so both see one row order), and
    the one-rank exchange matches JAX's count_sharded_bucketed: the same
    overflow flag and, when it fits, the same table array for array (both
    packages order a 64-lane table by the row hash)."""
    from shortseq_tpu.count.device import unique_count as jax_unique_count

    n, d, factor = 400, 1, 0.25
    words, lengths = _rows_150nt(keys, n, keys)
    weights = np.ones(n, np.int32)
    if pre_dedup:
        j = jax_unique_count(jnp.asarray(words), jnp.asarray(lengths),
                             jnp.asarray(weights))
        words, lengths, weights = (np.asarray(x) for x in j[:3])
        assert (lengths == PAD_LENGTH).sum() == n - keys
    cap = tdc.bucket_capacity(n, d, factor)
    got = tdc.bucket_send_buffers_plain(*_t(words, lengths, weights), d, cap)
    want = _reference_send(words, lengths, weights, d, cap)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])
    assert int(got[3]) == want[3] == int((keys if pre_dedup else n) > cap)

    raw_words, raw_lengths = _rows_150nt(keys, n, keys)
    j_w, j_l, j_c, j_n, j_over = jax_bucketed(
        jax_mesh(jax.devices()[:1]), factor, replicate=False,
        pre_dedup=pre_dedup)(jnp.asarray(raw_words), jnp.asarray(raw_lengths),
                             jnp.asarray(np.ones(n, np.int32)))
    assert int(j_over) == int(got[3])
    if int(j_over):
        return
    u_w, u_l, u_c, u_n = unique_count(*got[:3])
    assert int(u_n) == int(j_n) == keys
    np.testing.assert_array_equal(u_w.numpy().view(np.uint32), np.asarray(j_w))
    np.testing.assert_array_equal(u_l.numpy(), np.asarray(j_l))
    np.testing.assert_array_equal(u_c.numpy(), np.asarray(j_c))


@pytest.mark.parametrize("w,vec,tile", [(1, 4, 4096), (2, 8, 4096),
                                        (5, 4, 819), (6, 8, 1365),
                                        (64, 16, 256), (256, 16, 64)])
def test_k10_plan_tiles(w, vec, tile):
    """One-pass tiles hold 4096 row pieces, the widest piece that the row
    and the alignment allow."""
    plan = tdc.k10_plan(10_000, w, 3, 16)
    assert plan.one_pass and (plan.vec_bytes, plan.tile_rows) == (vec, tile)
    assert plan.n_tiles == -(-10_000 // tile)
    assert plan.scratch_ints == plan.zeroed == 2 + 3 + 3 * plan.n_tiles
    if w % 2 == 0:   # rows at 4-byte alignment take 4-byte pieces
        assert tdc.k10_plan(10_000, w, 3, 4).vec_bytes == 4


@pytest.mark.parametrize("d,one_pass", [(1024, True), (1025, False),
                                        (65536, False)])
def test_k10_plan_bucket_limit(d, one_pass):
    plan = tdc.k10_plan(50_000, 2, d, 16)
    assert plan.one_pass == one_pass
    if not one_pass:
        assert plan.zeroed == d * plan.n_tiles
        assert plan.scratch_ints == d * plan.n_tiles + 2 * 50_000 + d


def test_k10_plan_budget_grows_three_launch_tiles(monkeypatch):
    monkeypatch.setattr(tdc, "_HISTOGRAM_INTS", 64)
    plan = tdc.k10_plan(40_971, 2, 17, 16)
    assert not plan.one_pass and plan.tile_rows == 16384
    assert 17 * plan.n_tiles <= 64
    assert tdc.k10_plan(4000, 2, 17, 16).one_pass   # 1 tile x 17 fits


def _exchange(words, lengths, weights, d, factor, pre_dedup):
    """The port's tier on d emulated ranks: each rank's send buffers, the
    exchange, and unique_count per receiving rank."""
    n = len(lengths) // d
    ranks = [_t(words[r * n:(r + 1) * n], lengths[r * n:(r + 1) * n],
                weights[r * n:(r + 1) * n]) for r in range(d)]
    if pre_dedup:
        ranks = [unique_count(*x)[:3] for x in ranks]
    cap = tdc.bucket_capacity(n, d, factor)
    bufs = [tdc.bucket_send_buffers(*x, d, cap) for x in ranks]
    slabs = [unique_count(*(torch.cat([b[k][r * cap:(r + 1) * cap]
                                       for b in bufs]) for k in range(3)))
             for r in range(d)]
    return slabs, max(int(b[3]) for b in bufs), cap


@pytest.mark.parametrize("pre_dedup", [False, True])
@pytest.mark.parametrize("kind", ["benign", "duplicates", "skewed"])
@pytest.mark.parametrize("d", [2, 3, 6])
def test_exchange_matches_jax_slabs(d, kind, pre_dedup):
    """slab d of JAX's count_sharded_bucketed(replicate=False) over d CPU
    devices, array for array, and the same overflow flag."""
    rng = np.random.default_rng(10 * d + len(kind))
    n = 120 * d
    factor = 2.0
    if kind == "skewed":
        # Distinct keys all in bucket 0: tier 1 and pre-dedup overflow.
        words = _one_bucket_keys(d, n, d)
        lengths = np.full(n, 20, np.int32)
        factor = 0.5
    else:
        words, lengths = _rows(d, n, 2, pad_every=7)
        if kind == "duplicates":
            # One dominant key: overflows raw, fits after a pre-dedup.
            dom = rng.random(n) < 0.7
            words[dom] = words[0]
            lengths[dom] = 20
            factor = 1.0
    weights = rng.integers(1, 4, size=n).astype(np.int32)
    mesh = jax_mesh(jax.devices()[:d])
    j_w, j_l, j_c, j_n, j_over = jax_bucketed(
        mesh, factor, replicate=False, pre_dedup=pre_dedup)(
        jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(weights))
    j_w, j_l, j_c = (np.asarray(x) for x in (j_w, j_l, j_c))
    slabs, overflow, cap = _exchange(words, lengths, weights, d, factor,
                                     pre_dedup)
    assert overflow == int(j_over)
    assert sum(int(s[3]) for s in slabs) == int(j_n)
    rows = d * cap
    for r, (u_w, u_l, u_c, _) in enumerate(slabs):
        np.testing.assert_array_equal(u_w.numpy().view(np.uint32),
                                      j_w[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(u_l.numpy(),
                                      j_l[r * rows:(r + 1) * rows])
        np.testing.assert_array_equal(u_c.numpy(),
                                      j_c[r * rows:(r + 1) * rows])
    want_over = {"benign": 0, "duplicates": int(not pre_dedup),
                 "skewed": 1}[kind]
    assert overflow == want_over


@pytest.mark.parametrize("replicate", [False, True])
def test_single_rank_bucketed_matches_jax(replicate):
    """The port's count_sharded_bucketed on an ungrouped one-rank mesh
    against JAX's on one device."""
    from shortseq_torch.dist import data_mesh

    words, lengths = _rows(4, 900, 6, pad_every=4)
    weights = np.arange(900, dtype=np.int32) % 5 + 1
    got = tdc.count_sharded_bucketed(data_mesh(device="cpu"),
                                     replicate=replicate)(
        *_t(words, lengths, weights))
    want = jax_bucketed(jax_mesh(jax.devices()[:1]), replicate=replicate)(
        jnp.asarray(words), jnp.asarray(lengths), jnp.asarray(weights))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want[0]))
    for g, w_ in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))


def _card_cases():
    tile2 = tdc.k10_plan(1, 2, 1, 16).tile_rows
    tile64 = tdc.k10_plan(1, 64, 1, 16).tile_rows
    cases = []
    for d, n, w in ((1, tile2 - 1, 2), (2, tile2, 2), (3, tile2 + 1, 2),
                    (2, 9 * tile2 + 3, 2), (6, 3 * tile2 + 5, 5),
                    (8, 4 * tile64, 64), (1, tile64 + 1, 64), (3, 37, 1),
                    (1024, 3 * tile2 + 1, 2), (1025, 3 * tile2 + 1, 2)):
        cases.append((f"d={d} n={n} w={w}", *_rows(n + d, n, w,
                                                   pad_every=3), d, None))
    keys = _one_bucket_keys(0, 3 * tile2 // 2, 6)
    for extra, name in ((0, "cap rows fit"), (1, "cap + 1 overflow")):
        lengths = np.full(len(keys), 20, np.int32)
        cases.append((f"one bucket, {name}", keys, lengths, 6,
                      len(keys) - extra))
    for d in (1, 4):
        cases.append((f"n = 1, d = {d}", np.array([[3, 4]], np.uint32),
                      np.array([9], np.int32), d, 1))
    cases.append(("n = 0", np.zeros((0, 2), np.uint32),
                  np.zeros(0, np.int32), 4, 0))
    return cases


def test_kernel_matches_plain_on_card(cuda, monkeypatch):
    for name, words, lengths, d, cap in _card_cases():
        weights = np.arange(len(lengths), dtype=np.int32) % 7 + 1
        args = [x.to(cuda) for x in _t(words, lengths, weights)]
        if cap is None:
            cap = tdc.bucket_capacity(len(lengths), d, 2.0)
        got = tdc.bucket_send_buffers(*args, d, cap)
        want = tdc.bucket_send_buffers_plain(*args, d, cap)
        torch.cuda.synchronize()
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_), name
    # Pre-deduped rows: live rows, then PAD rows, as tier 2 hands them.
    words, lengths = _rows_150nt(1, 20_000, 3000)
    args = [x.to(cuda) for x in _t(words, lengths)]
    table = unique_count(*args)[:3]
    for d, factor in ((1, 0.25), (3, 2.0)):
        cap = tdc.bucket_capacity(20_000, d, factor)
        got = tdc.bucket_send_buffers(*table, d, cap)
        want = tdc.bucket_send_buffers_plain(*table, d, cap)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), d
    # A histogram budget of 64 ints: three launches, tiles past 1024 rows.
    monkeypatch.setattr(tdc, "_HISTOGRAM_INTS", 64)
    words, lengths = _rows(9, 5 * tdc.BUCKET_TILE_ROWS + 3, 2, pad_every=5)
    args = [x.to(cuda) for x in _t(words, lengths)]
    for d in (3, 40):
        cap = tdc.bucket_capacity(len(lengths), d, 2.0)
        got = tdc.bucket_send_buffers(*args, d, cap)
        want = tdc.bucket_send_buffers_plain(*args, d, cap)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want)), d
