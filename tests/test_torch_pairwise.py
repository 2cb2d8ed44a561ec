"""shortseq_torch all-pairs hamming (kernel B's plain version on the CPU,
the kernel itself on a card) against the JAX package's Pallas kernel, run
in interpret mode as tests/test_pallas_kernels.py runs it, and against its
broadcast hamming_pairwise.  Exact comparisons (integer outputs)."""

import numpy as np
import pytest
import torch

from shortseq_torch.ops import hamming_pairwise_tiled, pairwise_hamming
from shortseq_torch.ops.lanes import from_numpy_u32
from shortseq_tpu.ops import hamming_pairwise as jax_hamming_pairwise
from shortseq_tpu.ops import hamming_pairwise_tiled as jax_tiled


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _rand_words(n, w, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)


def _umi_like(n, w, seed):
    """Packed words of random 2-bit codes with a few one-code variants, so
    small distances (the ones the UMI stage keeps) really occur."""
    rng = np.random.default_rng(seed)
    words = _rand_words(n, w, seed)
    words[n // 2:] = words[:n - n // 2] ^ (
        np.uint32(1) << (2 * rng.integers(0, 16, size=(n - n // 2, 1))
                         ).astype(np.uint32))
    return words


@pytest.mark.parametrize("n,m,w", [(130, 70, 2), (200, 150, 6),
                                   (70, 130, 64)])
def test_plain_matches_pallas_interpret(n, m, w):
    a, b = _rand_words(n, w, 1), _umi_like(m, w, 2)
    got = pairwise_hamming(a, b).numpy()
    want = np.asarray(jax_tiled(a, b, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m,w", [(130, 70, 2), (257, 129, 6),
                                   (33, 300, 64), (1, 1, 2)])
def test_plain_matches_jax_broadcast(n, m, w):
    a = _umi_like(n, w, 3)
    b = np.concatenate([a, _rand_words(m, w, 4)])[:m]
    got = hamming_pairwise_tiled(from_numpy_u32(a), from_numpy_u32(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, m)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_hamming_pairwise(a, b)))


def test_out_buffer_is_filled_and_returned():
    a, b = _rand_words(20, 2, 5), _rand_words(30, 2, 6)
    out = torch.full((20, 30), -7, dtype=torch.int32)
    res = hamming_pairwise_tiled(from_numpy_u32(a), from_numpy_u32(b),
                                 out=out)
    assert res is out
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jax_hamming_pairwise(a, b)))


def test_rejects_bad_shapes():
    a = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="pairwise operands"):
        hamming_pairwise_tiled(a, torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="out must be"):
        hamming_pairwise_tiled(a, a, out=torch.empty((4, 5),
                                                     dtype=torch.int32))


@pytest.mark.parametrize("n,m,w", [(130, 70, 2), (257, 1000, 6),
                                   (64, 65, 64), (2688, 4097, 2)])
def test_kernel_matches_plain_on_card(cuda, n, m, w):
    a = from_numpy_u32(_umi_like(n, w, 7)).to(cuda)
    b = from_numpy_u32(_rand_words(m, w, 8)).to(cuda)
    before = hamming_pairwise_tiled.launches
    got = hamming_pairwise_tiled(a, b)
    assert hamming_pairwise_tiled.launches == before + 1
    want = pairwise_hamming(a.cpu(), b.cpu())
    assert torch.equal(got.cpu(), want)
