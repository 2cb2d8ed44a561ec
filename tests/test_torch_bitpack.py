"""shortseq_torch pack + validate (kernel A's plain version on the CPU, the
kernel itself on a card) and int32 lane helpers, against the JAX package
on identical numpy inputs.  Every output is an integer or a bool, so every
comparison is exact (tolerance 0)."""

import numpy as np
import pytest
import torch

from shortseq_torch.constants import BLOOM
from shortseq_torch.ops import bitpack as tb
from shortseq_torch.ops.lanes import (from_numpy_u32, popcount32, srl,
                                      to_numpy_u32)
from shortseq_tpu.count.ingest import pack_validate_padded
from shortseq_tpu.ops import bitpack as jb

BLOOM_PASS = np.array([not (BLOOM >> (c & 63)) & 1 for c in range(256)])
ALPHA = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _probe_rows(w4, seed):
    """Byte matrix [N, 4*w4] + lengths putting every one of the 256 byte
    values at every position: cyclic rows (value (p + j) % 256 at position
    p) at several lengths, plus single-probe rows on a valid background
    whose length ends just before, at, or past the probe."""
    rng = np.random.default_rng(seed)
    width = 4 * w4
    pos = np.arange(width)
    cyc = ((pos[None, :] + np.arange(256)[:, None]) % 256).astype(np.uint8)
    mats, lens = [], []
    for lng in (0, 1, 5, width // 2, width):
        mats.append(cyc)
        lens.append(np.full(256, lng))
    # Single probes: all positions for narrow rows, every 7th for wide.
    probe_pos = pos if width <= 96 else pos[::7]
    p = np.repeat(probe_pos, 256)
    c = np.tile(np.arange(256), len(probe_pos)).astype(np.uint8)
    bg = ALPHA[rng.integers(0, 4, size=(len(p), width))]
    bg[np.arange(len(p)), p] = c
    mats.append(bg)
    lens.append(p + rng.integers(0, 2, size=len(p))
                + (rng.random(len(p)) < 0.2) * width)
    mat = np.ascontiguousarray(np.concatenate(mats))
    lens = np.minimum(np.concatenate(lens), width).astype(np.int32)
    return mat, lens


def _assert_pack_equal(words_t, ok_t, words_j, ok_j):
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    # Words of rows that are not ok are unspecified in both packages.
    np.testing.assert_array_equal(to_numpy_u32(words_t)[ok_j],
                                  np.asarray(words_j)[ok_j])


class TestLanes:
    def test_popcount_matches_python(self):
        rng = np.random.default_rng(0)
        v = rng.integers(0, 2**32, size=5000, dtype=np.uint64).astype(
            np.uint32)
        v[:4] = [0, 1, 0x80000000, 0xFFFFFFFF]
        got = popcount32(from_numpy_u32(v)).numpy()
        want = np.array([bin(int(x)).count("1") for x in v])
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("n", [1, 6, 16, 24, 31])
    def test_logical_shift_matches_uint32(self, n):
        rng = np.random.default_rng(n)
        v = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(
            np.uint32)
        np.testing.assert_array_equal(
            to_numpy_u32(srl(from_numpy_u32(v), n)), v >> np.uint32(n))

    def test_bit_view_round_trip(self):
        v = np.array([[0, 0xFFFFFFFF], [0x80000000, 12345]], np.uint32)
        t = from_numpy_u32(v)
        assert t.dtype == torch.int32 and t[0, 1].item() == -1
        np.testing.assert_array_equal(to_numpy_u32(t), v)


class TestPackValidate:
    @pytest.mark.parametrize("w4", [8, 24, 256])
    @pytest.mark.parametrize("pad_valid", [False, True])
    def test_plain_matches_jax_all_bytes(self, w4, pad_valid):
        mat, lens = _probe_rows(w4, seed=w4)
        x = mat.view(np.uint32)
        words_t, ok_t = tb.pack_and_validate_u32(
            from_numpy_u32(x), torch.from_numpy(lens), pad_valid=pad_valid)
        words_j, ok_j = jb.pack_and_validate_u32(x, lens,
                                                 pad_valid=pad_valid)
        _assert_pack_equal(words_t, ok_t, words_j, ok_j)
        # Both kinds of rows really occur.
        assert 0 < int(ok_t.sum()) < len(lens)

    @pytest.mark.parametrize("w4", [4, 24, 256])
    @pytest.mark.parametrize("pad_valid", [False, True])
    def test_plain_matches_jax_at_length_edges(self, w4, pad_valid):
        """Lengths 0, one byte either side of every lane and word edge,
        and the full width, on rows with one bad byte at a random place
        and on all-valid rows: the mask's edges that kernel A's tail_mask
        computes per lane."""
        rng = np.random.default_rng(w4 + pad_valid)
        width = 4 * w4
        edges = sorted({0, width} | {min(max(e + k, 0), width)
                                     for e in range(0, width + 1, 4)
                                     for k in (-1, 0, 1)})
        lens = np.repeat(np.array(edges, np.int32), 2)
        mat = ALPHA[rng.integers(0, 4, size=(len(lens), width))]
        tail = np.arange(width)[None, :] >= lens[:, None]
        mat[tail] = 1 if pad_valid else 0
        bad = rng.integers(0, width, size=len(lens))
        mat[0::2][np.arange(len(lens) // 2), bad[0::2]] = ord("N")
        x = np.ascontiguousarray(mat).view(np.uint32)
        words_t, ok_t = tb.pack_and_validate_plain(
            from_numpy_u32(x), torch.from_numpy(lens), pad_valid)
        words_j, ok_j = jb.pack_and_validate_u32(x, lens, pad_valid=pad_valid)
        _assert_pack_equal(words_t, ok_t, words_j, ok_j)
        # Rows with no bad byte before their length are ok in both.
        assert ok_t[1::2].all()
        # pad_valid reads the tail too, where a bad byte also fails.
        want_bad = (bad[0::2] < lens[0::2]) | pad_valid
        np.testing.assert_array_equal(~ok_t[0::2].numpy(), want_bad)

    def test_bloom_per_byte_value(self):
        # One probe byte after 'A': ok iff the reference bloom passes it.
        mat = np.zeros((256, 16), np.uint8)
        mat[:, 0] = ord("A")
        mat[:, 1] = np.arange(256)
        lens = np.full(256, 2, np.int32)
        _, ok = tb.pack_and_validate_rows(mat.view(np.uint32), lens,
                                          device="cpu")
        np.testing.assert_array_equal(ok.numpy(), BLOOM_PASS)

    @pytest.mark.parametrize("pad_valid", [False, True])
    def test_rows_match_pack_validate_padded(self, pad_valid):
        rng = np.random.default_rng(5)
        n, width = 1000, 32
        mat = ALPHA[rng.integers(0, 4, size=(n, width))]
        lens = rng.integers(0, width + 1, size=n).astype(np.int32)
        tail = np.arange(width)[None, :] >= lens[:, None]
        mat[tail] = 1 if pad_valid else 0          # PAD_BYTE or foreign 0
        bad = rng.random(mat.shape) < 0.005
        mat[bad] = rng.integers(0, 256, size=int(bad.sum()))
        words_t, ok_t = tb.pack_and_validate_rows(
            mat.view(np.uint32), lens, pad_valid=pad_valid, device="cpu")
        words_j, ok_j = pack_validate_padded(mat, lens, min_pad=1,
                                             pad_valid=pad_valid)
        assert words_t.device.type == "cpu"
        _assert_pack_equal(words_t, ok_t, np.asarray(words_j)[:n], ok_j)

    def test_rejects_lane_count_not_multiple_of_4(self):
        with pytest.raises(ValueError, match="multiple of 4"):
            tb.pack_and_validate_u32(torch.zeros((2, 6), dtype=torch.int32),
                                     torch.zeros(2, dtype=torch.int32))

    @pytest.mark.parametrize("w4", [4, 8, 12, 20, 24, 40, 256])
    def test_kernel_matches_plain_on_card(self, cuda, w4):
        mat, lens = _probe_rows(w4, seed=w4 + 1)
        x = from_numpy_u32(mat.view(np.uint32)).to(cuda)
        ln = torch.from_numpy(lens).to(cuda)
        for pad_valid in (False, True):
            before = tb.pack_and_validate_u32.launches
            got = tb.pack_and_validate_u32(x, ln, pad_valid)
            want = tb.pack_and_validate_plain(x, ln, pad_valid)
            assert tb.pack_and_validate_u32.launches == before + 1
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
