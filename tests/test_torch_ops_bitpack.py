"""shortseq_torch's pack without validation (kernel A's pack-only mode),
unpack to ASCII (kernel E), validity masks and first-bad-byte indices,
against the JAX package's functions on identical numpy inputs: every byte
value at every position where bytes go in.  Integer and bool outputs, so
every comparison is exact (tolerance 0).  The kernels themselves run only
on a card; here the wrappers take their plain versions."""

import numpy as np
import pytest
import torch

from shortseq_torch.ops import bitpack as tb
from shortseq_torch.ops.lanes import from_numpy_u32, to_numpy_u32
from shortseq_tpu.ops import bitpack as jb
from tests.test_torch_bitpack import _probe_rows


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _rand_words(n, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


@pytest.mark.parametrize("w4", [4, 8, 24, 256])
def test_pack_words_u32_matches_jax_all_bytes(w4):
    mat, _ = _probe_rows(w4, seed=w4)
    x = mat.view(np.uint32)
    got = tb.pack_words_u32(from_numpy_u32(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(x), w4 // 4)
    np.testing.assert_array_equal(to_numpy_u32(got),
                                  np.asarray(jb.pack_words_u32(x)))


@pytest.mark.parametrize("w4", [8, 24])
def test_pack_words_u8_and_pack_rows_match_jax(w4):
    mat, _ = _probe_rows(w4, seed=w4 + 7)
    want = np.asarray(jb.pack_words(mat))
    np.testing.assert_array_equal(
        to_numpy_u32(tb.pack_words(torch.from_numpy(mat))), want)
    got = tb.pack_rows(mat.view(np.uint32), device="cpu")
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(
        to_numpy_u32(got), np.asarray(jb.pack_rows(mat.view(np.uint32))))
    np.testing.assert_array_equal(to_numpy_u32(got), want)


def test_zero_padding_packs_to_code_0():
    mat = np.zeros((2, 32), np.uint8)
    mat[0, :5] = np.frombuffer(b"GATTC", np.uint8)
    got = to_numpy_u32(tb.pack_words(torch.from_numpy(mat)))
    np.testing.assert_array_equal(got, np.asarray(jb.pack_words(mat)))
    assert got[1].tolist() == [0, 0] and got[0, 1] == 0


def test_pack_words_rejects_lane_count_not_multiple_of_4():
    with pytest.raises(ValueError, match="multiple of 4"):
        tb.pack_words_u32(torch.zeros((2, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 4"):
        tb.pack_rows(np.zeros((2, 6), np.uint32), device="cpu")
    with pytest.raises(ValueError, match="multiple of 4"):
        jb.pack_words_u32(np.zeros((2, 6), np.uint32))
    with pytest.raises(ValueError, match="multiple of 4"):
        tb.pack_words(torch.zeros((2, 18), dtype=torch.uint8))


@pytest.mark.parametrize("n,w", [(5, 1), (40, 3), (17, 10), (9, 64)])
def test_unpack_ascii_matches_jax(n, w):
    words = _rand_words(n, w, seed=n * w)
    got = tb.unpack_ascii(from_numpy_u32(words))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n, 16 * w)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jb.unpack_ascii(words)))
    for out_len in (0, 1, 16 * w - 3, 16 * w, 16 * w + 5):
        np.testing.assert_array_equal(
            tb.unpack_ascii(from_numpy_u32(words), out_len).numpy(),
            np.asarray(jb.unpack_ascii(words, out_len)))


def test_unpack_inverts_pack_of_every_base():
    seqs = np.frombuffer(b"ACGT" * 8 + b"TGCA" * 8, np.uint8)
    seqs = seqs.reshape(2, 32).copy()
    words = tb.pack_words(torch.from_numpy(seqs))
    np.testing.assert_array_equal(tb.unpack_ascii(words).numpy(), seqs)


@pytest.mark.parametrize("w4", [8, 40])
def test_validate_and_first_bad_byte_match_jax_all_bytes(w4):
    mat, lens = _probe_rows(w4, seed=w4 + 3)
    x = mat.view(np.uint32)
    xt, lt = from_numpy_u32(x), torch.from_numpy(lens)
    ok_j = np.asarray(jb.validate_u32(x, lens))
    np.testing.assert_array_equal(tb.validate_u32(xt, lt).numpy(), ok_j)
    np.testing.assert_array_equal(
        tb.validate(torch.from_numpy(mat), lt).numpy(),
        np.asarray(jb.validate(mat, lens)))
    first_j = np.asarray(jb.first_bad_byte_u32(x, lens))
    first_t = tb.first_bad_byte_u32(xt, lt)
    assert first_t.dtype == torch.int32
    np.testing.assert_array_equal(first_t.numpy(), first_j)
    np.testing.assert_array_equal(
        tb.first_bad_byte(torch.from_numpy(mat), lt).numpy(),
        np.asarray(jb.first_bad_byte(mat, lens)))
    # Both kinds of rows occur, and "none" reads 4 * W4.
    assert 0 < ok_j.sum() < len(ok_j)
    np.testing.assert_array_equal(first_j == 4 * w4, ok_j)


@pytest.mark.parametrize("w4", [8, 24])
def test_pack_and_validate_u8_matches_jax(w4):
    mat, lens = _probe_rows(w4, seed=w4 + 5)
    words_t, ok_t = tb.pack_and_validate(torch.from_numpy(mat),
                                         torch.from_numpy(lens))
    words_j, ok_j = jb.pack_and_validate(mat, lens)
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(to_numpy_u32(words_t)[ok_j],
                                  np.asarray(words_j)[ok_j])


# --- on the card ------------------------------------------------------------


@pytest.mark.parametrize("w4", [4, 8, 12, 20, 24, 36, 40, 256])
def test_pack_only_kernel_matches_plain_on_card(cuda, w4):
    mat, _ = _probe_rows(w4, seed=w4 + 11)
    x = from_numpy_u32(mat.view(np.uint32)).to(cuda)
    before = (tb.pack_words_u32.launches, tb.pack_and_validate_u32.launches)
    got = tb.pack_words_u32(x)
    assert (tb.pack_words_u32.launches,
            tb.pack_and_validate_u32.launches) == (before[0] + 1, before[1])
    assert torch.equal(got, tb.pack_words_plain(x))


@pytest.mark.parametrize("n,w", [(1, 1), (1000, 3), (4097, 10), (300, 64)])
def test_unpack_kernel_matches_plain_on_card(cuda, n, w):
    words = from_numpy_u32(_rand_words(n, w, seed=n + w)).to(cuda)
    before = tb.unpack_ascii.launches
    got = tb.unpack_ascii(words)
    assert tb.unpack_ascii.launches == before + 1
    assert torch.equal(got, tb.unpack_ascii_plain(words))
    assert torch.equal(tb.unpack_ascii(words, 7), got[:, :7])


def test_validity_ops_on_card_match_cpu(cuda):
    mat, lens = _probe_rows(24, seed=2)
    x = from_numpy_u32(mat.view(np.uint32))
    lt = torch.from_numpy(lens)
    assert torch.equal(tb.validate_u32(x.to(cuda), lt.to(cuda)).cpu(),
                       tb.validate_u32(x, lt))
    assert torch.equal(tb.first_bad_byte_u32(x.to(cuda), lt.to(cuda)).cpu(),
                       tb.first_bad_byte_u32(x, lt))
