"""shortseq_torch all-pairs hamming (kernel B's plain version on the CPU,
the kernel itself on a card) against the JAX package's Pallas kernel, run
in interpret mode as tests/test_pallas_kernels.py runs it, and against its
broadcast hamming_pairwise; then the calibrated selector
(calibrate_pairwise, pairwise_hamming_auto), as tests/test_pallas_kernels.py
covers the JAX one.  Exact comparisons (integer outputs).  The calibration
cache goes to a temporary directory, never to the home directory."""

import json

import numpy as np
import pytest
import torch

from shortseq_torch.ops import (hamming_pairwise, hamming_pairwise_tiled,
                                pairwise_hamming_auto)
from shortseq_torch.ops import pairwise as tp
from shortseq_torch.ops.lanes import from_numpy_u32
from shortseq_tpu.ops import hamming_pairwise as jax_hamming_pairwise
from shortseq_tpu.ops import hamming_pairwise_tiled as jax_tiled
from tests.conftest import rand_sequence


@pytest.fixture(autouse=True)
def calib_cache(tmp_path, monkeypatch):
    """A private, empty calibration cache for every test."""
    path = str(tmp_path / "calib.json")
    monkeypatch.setattr(tp, "_calib_file", lambda: path)
    monkeypatch.setattr(tp, "_CALIBRATION", {})
    monkeypatch.delenv("SHORTSEQ_TORCH_PAIRWISE", raising=False)
    return path


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
def test_plain_matches_pallas_interpret(n, m, w, monkeypatch):
    monkeypatch.setenv("SHORTSEQ_TORCH_PAIRWISE", "plain")
    a, b = _rand_words(n, w, 1), _umi_like(m, w, 2)
    got = pairwise_hamming_auto(a, b).numpy()
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
    want = hamming_pairwise(a.cpu(), b.cpu())
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("w", [1, 2, 3, 5, 10, 17, 64, 67])
@pytest.mark.parametrize("n,m", [(1, 1), (129, 259), (300, 1025),
                                 (257, 4098)])
def test_tiles_and_ragged_edges_on_card(cuda, n, m, w):
    """Kernel B's 128 x 128 tiles: N and M off the tile, M % 4 != 0 (rows
    that start off a 16-byte boundary), odd W (a lone last lane), W = 67
    (two staging rounds of 64 lanes), and an `out` view that starts 4
    bytes into its buffer."""
    a = from_numpy_u32(_umi_like(n, w, 15)).to(cuda)
    b = from_numpy_u32(_rand_words(m, w, 16)).to(cuda)
    b[: min(n, m)] = a[: min(n, m)] ^ 12            # small distances too
    want = hamming_pairwise(a.cpu(), b.cpu())
    assert torch.equal(hamming_pairwise_tiled(a, b).cpu(), want)
    buf = torch.full((n * m + 1,), -1, dtype=torch.int32, device=cuda)
    out = buf[1:].view(n, m)
    hamming_pairwise_tiled(a, b, out=out)
    assert torch.equal(out.cpu(), want) and int(buf[0]) == -1


# --- calibration and the selector ------------------------------------------


def test_calibration_measures_and_caches(calib_cache):
    times = tp.calibrate_pairwise(2, "cpu", force=True)
    assert set(times) == {"plain", "onehot"}
    assert all(t > 0 for t in times.values())
    winner = min(times, key=times.get)
    assert tp._CALIBRATION["cpu/w2"] == winner
    with open(calib_cache) as f:
        assert json.load(f)["cpu/w2"] == {"winner": winner, "times": times}
    # In memory: nothing to measure.  Fresh memory: the disk answers.
    assert tp.calibrate_pairwise(2, "cpu") is None
    tp._CALIBRATION.clear()
    assert tp.calibrate_pairwise(2, "cpu") == times
    assert tp._CALIBRATION["cpu/w2"] == winner


def test_calibration_keeps_other_widths_and_skips_bad_entries(calib_cache):
    with open(calib_cache, "w") as f:
        json.dump({"cpu/w1": {"winner": "tiled", "times": {}},
                   "cuda/X/w1": {"winner": "onehot", "times": {"a": 1}}}, f)
    # "tiled" is no CPU candidate: the entry is measured again.
    times = tp.calibrate_pairwise(1, "cpu")
    assert set(times) == {"plain", "onehot"}
    with open(calib_cache) as f:
        disk = json.load(f)
    assert disk["cuda/X/w1"]["winner"] == "onehot"
    assert disk["cpu/w1"]["winner"] in ("plain", "onehot")


def test_auto_calibrates_once_and_counts_its_path():
    a = from_numpy_u32(_umi_like(50, 2, 11))
    before = dict(pairwise_hamming_auto.paths)
    got = pairwise_hamming_auto(a, a)
    winner = tp._CALIBRATION["cpu/w2"]
    assert winner in ("plain", "onehot")
    pairwise_hamming_auto(a, a)
    assert pairwise_hamming_auto.paths[winner] == before[winner] + 2
    assert torch.equal(got, hamming_pairwise(a, a))


@pytest.mark.parametrize("mode", ["plain", "onehot", "tiled"])
def test_env_override(monkeypatch, mode):
    a, b = _rand_words(64, 2, 12), _rand_words(48, 2, 13)
    want = np.asarray(jax_hamming_pairwise(a, b))
    monkeypatch.setenv("SHORTSEQ_TORCH_PAIRWISE", mode)
    before = pairwise_hamming_auto.paths[mode]
    np.testing.assert_array_equal(pairwise_hamming_auto(a, b).numpy(), want)
    assert pairwise_hamming_auto.paths[mode] == before + 1
    assert tp._CALIBRATION == {}


def test_env_override_rejects_unknown(monkeypatch):
    monkeypatch.setenv("SHORTSEQ_TORCH_PAIRWISE", "mxu")
    with pytest.raises(ValueError, match="SHORTSEQ_TORCH_PAIRWISE"):
        pairwise_hamming_auto(_rand_words(2, 2, 0), _rand_words(2, 2, 1))


def test_auto_matches_oracle(rng):
    from shortseq_torch.ops.bitpack import pack_words

    seqs = [rand_sequence(rng, 32) for _ in range(40)]
    mat = np.frombuffer("".join(seqs).encode(), np.uint8).reshape(40, 32)
    words = pack_words(torch.from_numpy(mat.copy()))
    dist = pairwise_hamming_auto(words, words).numpy()
    for i in range(0, len(seqs), 7):
        for j in range(0, len(seqs), 5):
            assert dist[i, j] == sum(x != y for x, y in zip(seqs[i], seqs[j]))


def test_plain_on_card_raises(cuda, monkeypatch):
    monkeypatch.setenv("SHORTSEQ_TORCH_PAIRWISE", "plain")
    a = from_numpy_u32(_rand_words(4, 2, 0)).to(cuda)
    with pytest.raises(ValueError, match="plain"):
        pairwise_hamming_auto(a, a)


def test_calibration_on_card_never_picks_plain(cuda):
    times = tp.calibrate_pairwise(10, cuda, force=True)
    assert set(times) == {"tiled", "onehot"}
    key = f"cuda/{torch.cuda.get_device_name(cuda)}/w10"
    assert tp._CALIBRATION[key] == min(times, key=times.get)
    a = from_numpy_u32(_umi_like(300, 10, 14)).to(cuda)
    got = pairwise_hamming_auto(a, a)
    assert torch.equal(got, hamming_pairwise_tiled(a, a))
