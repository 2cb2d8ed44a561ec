"""shortseq_torch row hamming (kernel G) and the one-hot pairwise product
against the JAX package's hamming_rows and hamming_pairwise_mxu on
identical numpy inputs.  Integer outputs: exact (tolerance 0).  The
near-identical rows give 1000 to 1023 matches per pair at W = 64, which a
bfloat16 result would round."""

import numpy as np
import pytest
import torch

from shortseq_torch.ops import hamming as th
from shortseq_torch.ops.lanes import from_numpy_u32
from shortseq_torch.ops.pairwise import hamming_pairwise_tiled
from shortseq_tpu.ops import hamming as jh


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _rand_words(n, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def _near(words, seed, max_subs=8):
    """A copy of `words` with 0..max_subs codes changed per row (each to
    another code, so a change is one substitution unless two land on one
    code)."""
    rng = np.random.default_rng(seed)
    out = words.copy()
    n, w = words.shape
    for i in range(n):
        for _ in range(int(rng.integers(0, max_subs + 1))):
            lane, pos = int(rng.integers(0, w)), int(rng.integers(0, 16))
            flip = np.uint32(int(rng.integers(1, 4)) << (2 * pos))
            out[i, lane] ^= flip
    return out


@pytest.mark.parametrize("w", [1, 2, 3, 4, 5, 10, 16, 33, 63, 64])
def test_hamming_rows_matches_jax(w):
    # 301 rows: not a multiple of the kernel's 4-word groups.
    a = _rand_words(301, w, w)
    b = np.concatenate([_near(a[:150], w + 1), _rand_words(151, w, w + 2)])
    got = th.hamming_rows(from_numpy_u32(a), from_numpy_u32(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (301,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jh.hamming_rows(a, b)))


def test_hamming_rows_rejects_mismatched_shapes():
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="row hamming"):
        th.hamming_rows(a, torch.zeros((4, 3), dtype=torch.int32))


@pytest.mark.parametrize("w", [1, 2, 10, 64])
def test_one_hot_codes_match_jax(w):
    words = _rand_words(20, w, 30 + w)
    got = th.one_hot_codes(from_numpy_u32(words))
    want = np.asarray(jh.one_hot_codes(words)).astype(np.float32)
    assert tuple(got.shape) == (20, 64 * w)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w", [1, 2, 10, 64])
def test_onehot_pairwise_matches_jax_mxu(w):
    a = _rand_words(40, w, 40 + w)
    b = np.concatenate([a, _near(a, 50 + w, max_subs=3),
                        _rand_words(9, w, 60 + w)])
    got = th.hamming_pairwise_onehot(from_numpy_u32(a), from_numpy_u32(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (40, 89)
    want = np.asarray(jh.hamming_pairwise_mxu(a, b))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, np.asarray(jh.hamming_pairwise(a, b)))
    if w == 64:
        # 1000-1023 matches: integers a bfloat16 product would round.
        near = 16 * w - want[np.arange(40), 40 + np.arange(40)]
        assert ((near >= 1000) & (near <= 1023)).sum() >= 30


# --- on the card ------------------------------------------------------------


@pytest.mark.parametrize("n,w", [(1, 1), (1000, 2), (4097, 10), (333, 33),
                                 (2000, 64)])
def test_row_kernel_matches_plain_on_card(cuda, n, w):
    # The rows as they are, then both operands 1 row off the base (off 16
    # bytes unless 4 divides W: the kernel's 4-byte instance), then one.
    a = _rand_words(n + 1, w, n)
    b = np.concatenate([_near(a[:n // 2], n + 1),
                        _rand_words(n + 1 - n // 2, w, n + 2)])
    at, bt = from_numpy_u32(a).to(cuda), from_numpy_u32(b).to(cuda)
    for x, y in ((at[:n], bt[:n]), (at[1:], bt[1:]), (at[1:], bt[:n])):
        before = th.hamming_rows.launches
        got = th.hamming_rows(x, y)
        assert th.hamming_rows.launches == before + 1
        assert torch.equal(got, th.hamming_rows_plain(x, y))


@pytest.mark.parametrize("w", [1, 2, 10, 64])
def test_onehot_matches_tiled_on_card(cuda, w):
    a = _rand_words(512, w, 70 + w)
    b = np.concatenate([_near(a, 80 + w, max_subs=2),
                        _rand_words(3000, w, 90 + w)])
    at, bt = from_numpy_u32(a).to(cuda), from_numpy_u32(b).to(cuda)
    assert th._onehot_dtype(at) == torch.float16
    assert torch.equal(th.hamming_pairwise_onehot(at, bt),
                       hamming_pairwise_tiled(at, bt))
