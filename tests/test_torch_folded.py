"""The JAX package's remaining names in shortseq_torch, against the JAX
functions on identical seeded numpy inputs: the row-folded pack names
(`fold_for`, `pack_and_validate_folded`, `pack_folded`), the ingest
padding (`quarter_pow2`, `pack_validate_padded`, `packed_buckets`' modes),
`count_indexed_device_table(batch_size=)`, the constants, the oracle's
helpers, `hamming_pairwise_mxu` and `LAST_PAIRWISE_PATH`.  Every output is
an integer or a bool, so every comparison is exact (tolerance 0); words of
rows whose ok is False are unspecified in both packages and compared only
where ok.  Kernel A itself runs only on a card; here the wrappers take its
plain version."""

import collections
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shortseq_torch import constants as tc
from shortseq_torch import oracle as to
from shortseq_torch.api import counter as tcounter
from shortseq_torch.count import ingest as ti
from shortseq_torch.io.fastq import read_fastq_index
from shortseq_torch.ops import bitpack as tb
from shortseq_torch.ops import hamming as th
from shortseq_torch.ops import pairwise as tp
from shortseq_torch.ops.lanes import from_numpy_u32, to_numpy_u32
from shortseq_tpu import constants as jc
from shortseq_tpu import oracle as jo
from shortseq_tpu.api import counter as jcounter
from shortseq_tpu.count import ingest as ji
from shortseq_tpu.ops import bitpack as jb
from shortseq_tpu.ops import hamming as jh
from tests.test_torch_bitpack import _probe_rows

ALPHA = np.frombuffer(b"ACGT", np.uint8)


def _folded(w4, seed):
    """_probe_rows' every-byte-everywhere rows, cut to a multiple of their
    fold: (x [N, w4] uint32, lengths [N] int32, fold)."""
    mat, lens = _probe_rows(w4, seed)
    x = mat.view(np.uint32)
    fold = jb.fold_for(w4, len(x) - len(x) % 64)
    n = len(x) - len(x) % fold
    return np.ascontiguousarray(x[:n]), lens[:n], fold


def _assert_where_ok(words_t, ok_t, words_j, ok_j, w):
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.any() and not ok_j.all()
    keep = ok_j.reshape(-1)
    np.testing.assert_array_equal(
        to_numpy_u32(words_t).reshape(-1, w)[keep],
        np.asarray(words_j).reshape(-1, w)[keep])


@pytest.mark.parametrize("target_lanes", [64, 128, 512])
def test_fold_for_matches_jax(target_lanes):
    for w4 in (1, 2, 4, 8, 12, 24, 40, 64, 128, 256, 600):
        for n in (-1, 0, 1, 2, 3, 6, 8, 12, 16, 48, 64, 96, 100, 128, 1000,
                  1024, 4097, 1 << 18, 10_000_000):
            assert tb.fold_for(w4, n, target_lanes) == \
                jb.fold_for(w4, n, target_lanes), (w4, n)
            assert tb.fold_for(w4, n, target_lanes=target_lanes) == \
                jb.fold_for(w4, n, target_lanes=target_lanes)


@pytest.mark.parametrize("pad_valid", [False, True])
@pytest.mark.parametrize("unfold", [True, False])
@pytest.mark.parametrize("w4", [8, 40])
def test_pack_and_validate_folded_matches_jax(w4, unfold, pad_valid):
    x, lens, fold = _folded(w4, seed=w4 + unfold)
    assert fold > 1
    nf = len(x) // fold
    x_f, l_f = x.reshape(nf, fold * w4), lens.reshape(nf, fold)
    words, ok = tb.pack_and_validate_folded(
        from_numpy_u32(x_f), torch.from_numpy(l_f), w4, unfold=unfold,
        pad_valid=pad_valid)
    want_w, want_ok = jb.pack_and_validate_folded(
        jnp.asarray(x_f), jnp.asarray(l_f), w4, unfold=unfold,
        pad_valid=pad_valid)
    shape = (len(x), w4 // 4) if unfold else (nf, fold * w4 // 4)
    assert tuple(words.shape) == shape == tuple(want_w.shape)
    assert tuple(ok.shape) == tuple(want_ok.shape)
    _assert_where_ok(words, ok, want_w, want_ok, w4 // 4)


@pytest.mark.parametrize("unfold", [True, False])
@pytest.mark.parametrize("w4", [8, 40])
def test_pack_folded_matches_jax(w4, unfold):
    x, _, fold = _folded(w4, seed=w4 + 5)
    x_f = x.reshape(len(x) // fold, fold * w4)
    got = tb.pack_folded(from_numpy_u32(x_f), w4, unfold=unfold)
    want = np.asarray(jb.pack_folded(jnp.asarray(x_f), w4, unfold=unfold))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_folded_refuses_a_ragged_fold():
    x = torch.zeros((3, 20), dtype=torch.int32)
    with pytest.raises(ValueError, match="folded lanes"):
        tb.pack_folded(x, 8)
    with pytest.raises(ValueError, match="folded lanes"):
        tb.pack_and_validate_folded(x, torch.zeros((3, 2), dtype=torch.int32),
                                    8)


@pytest.mark.parametrize("floor", [1, 64, 256])
def test_quarter_pow2_matches_jax(floor):
    for n in range(1, 1 << 14):
        assert ti.quarter_pow2(n, floor) == ji.quarter_pow2(n, floor), n
    for n in (0, -5, 1 << 20, (1 << 20) + 1, 10_000_000):
        assert ti.quarter_pow2(n, floor=floor) == \
            ji.quarter_pow2(n, floor=floor)


@pytest.mark.parametrize("pad_valid", [False, True])
@pytest.mark.parametrize("min_pad", [1, 256])
@pytest.mark.parametrize("w4", [8, 24])
def test_pack_validate_padded_matches_jax(w4, min_pad, pad_valid):
    mat, lens = _probe_rows(w4, seed=w4 + min_pad)
    n = len(mat) - 11
    mat, lens = mat[:n], lens[:n]
    words, ok = ti.pack_validate_padded(mat, lens, min_pad=min_pad,
                                        pad_valid=pad_valid, device="cpu")
    want_w, want_ok = ji.pack_validate_padded(mat, lens, min_pad=min_pad,
                                              pad_valid=pad_valid)
    assert words.device.type == "cpu" and isinstance(ok, np.ndarray)
    assert tuple(words.shape) == tuple(want_w.shape) == \
        (ti.quarter_pow2(n, min_pad), w4 // 4)
    assert ok.shape == (n,)
    _assert_where_ok(words[:n], torch.from_numpy(ok), np.asarray(want_w)[:n],
                     want_ok, w4 // 4)
    # The pad rows pack to zero words, in both.
    assert not to_numpy_u32(words[n:]).any()
    assert not np.asarray(want_w)[n:].any()


def test_pack_validate_padded_refuses_ragged_width():
    with pytest.raises(ValueError, match="multiple of 16"):
        ti.pack_validate_padded(np.zeros((2, 20), np.uint8),
                                np.zeros(2, np.int32), device="cpu")


def _ragged_index(tmp_path, seed=3):
    """A FASTQ of reads in all three width classes (0-32, 33-96, 97-300
    nt, empty reads too), indexed: (data, starts, lengths)."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.integers(0, 33, 97),
                              rng.integers(33, 97, 41),
                              rng.integers(97, 301, 23)])
    rng.shuffle(lengths)
    path = tmp_path / "ragged.fastq"
    with open(path, "w") as f:
        for i, k in enumerate(lengths):
            seq = ALPHA[rng.integers(0, 4, int(k))].tobytes().decode()
            f.write(f"@r{i}\n{seq}\n+\n{'I' * int(k)}\n")
    return read_fastq_index(str(path))


@pytest.mark.parametrize("batch_size", [None, 7])
@pytest.mark.parametrize("min_pad", [1, 256])
@pytest.mark.parametrize("pad_pow2", [True, False, "quarter"])
def test_packed_buckets_matches_jax(tmp_path, pad_pow2, min_pad, batch_size):
    data, starts, lengths = _ragged_index(tmp_path)
    got = list(ti.packed_buckets(data, starts, lengths, batch_size=batch_size,
                                 min_pad=min_pad, pad_pow2=pad_pow2))
    want = list(ji.packed_buckets(data, starts, lengths,
                                  batch_size=batch_size, min_pad=min_pad,
                                  pad_pow2=pad_pow2))
    assert len(got) == len(want) >= (3 if batch_size is None else 20)
    assert {w.shape[1] for w, _ in got} == {2, 6, 64}
    for (gw, gl), (ww, wl) in zip(got, want):
        assert gw.dtype == ww.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gl, wl)


def test_packed_buckets_defaults_pad_like_jax(tmp_path):
    """No padding argument: powers of two of at least 256 rows, as in the
    JAX package; the port's own callers pass pad_pow2=False."""
    data, starts, lengths = _ragged_index(tmp_path, seed=4)
    got = list(ti.packed_buckets(data, starts, lengths))
    want = list(ji.packed_buckets(data, starts, lengths))
    assert [len(l) for _, l in got] == [len(l) for _, l in want] == [256] * 3
    for (gw, gl), (ww, wl) in zip(got, want):
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gl, wl)
    with pytest.raises(ValueError, match="pad_pow2"):
        next(ti.packed_buckets(data, starts, lengths, pad_pow2="Quarter"))


@pytest.mark.parametrize("chunk_rows", [None, "8"])
@pytest.mark.parametrize("batch_size", [None, 7])
def test_count_indexed_device_table_batch_size_matches_jax(
        tmp_path, monkeypatch, batch_size, chunk_rows):
    data, starts, lengths = _ragged_index(tmp_path, seed=5)
    # Duplicates, so the table has counts above 1.
    reads = [bytes(data[s:s + n]).decode() for s, n in zip(starts, lengths)]
    path = tmp_path / "dups.fastq"
    with open(path, "w") as f:
        for i, r in enumerate(reads + reads[::2] + reads[::5]):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    data, starts, lengths = read_fastq_index(str(path))
    if chunk_rows:
        monkeypatch.setenv("SHORTSEQ_TORCH_H2D_CHUNK_ROWS", chunk_rows)
    got = tcounter.count_indexed_device_table(
        data, starts, lengths, batch_size=batch_size, device="cpu")
    want = jcounter.count_indexed_device_table(data, starts, lengths,
                                               batch_size=batch_size)
    items = [(str(k), v) for k, v in got.to_counter().items()]
    assert items == [(str(k), v) for k, v in want.to_counter().items()]
    assert dict(items) == dict(collections.Counter(
        reads + reads[::2] + reads[::5]))
    assert len(got) == len(want) and got.total() == want.total()
    eager = tcounter.count_indexed_device(data, starts, lengths,
                                          batch_size=batch_size, device="cpu")
    assert eager == got.to_counter()


def test_constants_match_jax():
    names = [n for n in vars(jc) if n.isupper()]
    assert len(names) > 25
    for name in names:
        assert getattr(tc, name) == getattr(jc, name), name
    for length in range(0, tc.MAX_VAR_NT + 1):
        assert tc.bucket_lanes(length) == jc.bucket_lanes(length)
    for fn in (tc.bucket_lanes, jc.bucket_lanes):
        with pytest.raises(ValueError, match="longer than 1024"):
            fn(tc.MAX_VAR_NT + 1)


def test_lanes_to_blocks_and_str_hamming_match_jax():
    rng = random.Random(7)
    for _ in range(200):
        n_blocks = rng.randint(0, 6)
        blocks = [rng.getrandbits(64) for _ in range(n_blocks)]
        lanes = to.blocks_to_lanes(blocks, 2 * n_blocks + rng.randint(0, 3))
        assert to.lanes_to_blocks(lanes, n_blocks) == \
            jo.lanes_to_blocks(lanes, n_blocks) == blocks
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 40)))
        b = "".join(rng.choice("ACGTN") for _ in range(rng.randint(0, 40)))
        assert to.str_hamming(a, b) == jo.str_hamming(a, b)


@pytest.mark.parametrize("w", [1, 2, 10, 64])
def test_hamming_pairwise_mxu_matches_jax(w):
    rng = np.random.default_rng(w)
    a, b = (rng.integers(0, 2**32, size=(n, w), dtype=np.uint64)
            .astype(np.uint32) for n in (9, 37))
    b[:3] = a[:3]
    got = th.hamming_pairwise_mxu(from_numpy_u32(a), from_numpy_u32(b))
    want = np.asarray(jh.hamming_pairwise_mxu(jnp.asarray(a), jnp.asarray(b)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert th.hamming_pairwise_mxu is th.hamming_pairwise_onehot


def test_collapse_xor_matches_jax():
    rng = np.random.default_rng(2)
    c = rng.integers(0, 2**32, size=(64, 5), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        to_numpy_u32(tb.collapse_xor(from_numpy_u32(c))),
        np.asarray(jb.collapse_xor(jnp.asarray(c))))
    assert th.collapse_xor is tb.collapse_xor


@pytest.mark.parametrize("mode", ["plain", "onehot"])
def test_last_pairwise_path_names_each_call(monkeypatch, mode):
    monkeypatch.setenv("SHORTSEQ_TORCH_PAIRWISE", mode)
    monkeypatch.setattr(tp, "LAST_PAIRWISE_PATH", None)
    before = dict(tp.pairwise_hamming_auto.paths)
    a = torch.tensor([[1], [2]], dtype=torch.int32)
    tp.pairwise_hamming_auto(a, a)
    assert tp.LAST_PAIRWISE_PATH == mode
    assert tp.pairwise_hamming_auto.paths[mode] == before[mode] + 1


def test_x_u32_keyword_matches_jax():
    mat, lens = _probe_rows(8, seed=1)
    x = mat.view(np.uint32)
    xt, lt = from_numpy_u32(x), torch.from_numpy(lens)
    np.testing.assert_array_equal(
        to_numpy_u32(tb.pack_words_u32(x_u32=xt)),
        np.asarray(jb.pack_words_u32(x_u32=jnp.asarray(x))))
    np.testing.assert_array_equal(
        tb.validate_u32(x_u32=xt, lengths=lt).numpy(),
        np.asarray(jb.validate_u32(x_u32=jnp.asarray(x),
                                   lengths=jnp.asarray(lens))))
    np.testing.assert_array_equal(
        tb.first_bad_byte_u32(x_u32=xt, lengths=lt).numpy(),
        np.asarray(jb.first_bad_byte_u32(x_u32=jnp.asarray(x),
                                         lengths=jnp.asarray(lens))))
    _, ok = tb.pack_and_validate_u32(x_u32=xt, lengths=lt, pad_valid=False)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(
        jb.pack_and_validate_u32(x_u32=jnp.asarray(x),
                                 lengths=jnp.asarray(lens))[1]))
