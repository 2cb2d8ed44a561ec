"""shortseq_torch.PackedBatch (device="cpu": the plain versions of kernels
A, E, F and G) against shortseq_tpu.PackedBatch built from the same
sequences, mirroring tests/test_batch.py: packed words, lengths, decoded
strings, distances and count tables must be identical (tolerance 0; count
tables in their dict order too, which is the row hash's order for
batches wider than 6 lanes in both packages).  Trimming is also held to the JAX
package's _trim_words / _trim_words_ragged directly, and to a Python
slice over a wide fuzz.  The pairwise selector calibrates into a
temporary directory; the JAX side is pinned to its broadcast path."""

import collections

import numpy as np
import pytest
import torch

import shortseq_torch as st
import shortseq_tpu as sq
from shortseq_torch import batch as tbatch
from shortseq_torch import constants as tconst
from shortseq_torch.ops import pairwise as tp
from shortseq_torch.ops.lanes import from_numpy_u32, to_numpy_u32
from shortseq_tpu import batch as jbatch
from shortseq_tpu import constants as jconst
from tests.conftest import rand_sequence


@pytest.fixture(autouse=True)
def _pairwise_env(tmp_path, monkeypatch):
    monkeypatch.setattr(tp, "_calib_file",
                        lambda: str(tmp_path / "calib.json"))
    monkeypatch.setattr(tp, "_CALIBRATION", {})
    monkeypatch.delenv("SHORTSEQ_TORCH_PAIRWISE", raising=False)
    monkeypatch.setenv("SHORTSEQ_TPU_PAIRWISE", "jnp")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


@pytest.fixture
def seqs(rng):
    return [rand_sequence(rng, rng.randint(1, 60)) for _ in range(37)]


def both(seqs, width=None):
    """(port batch on the CPU, JAX batch) of the same sequences."""
    return (st.pack_batch(seqs, width, device="cpu"),
            jbatch.pack_batch(seqs, width))


def assert_same(t, j):
    """Port batch == JAX batch, words and lengths."""
    np.testing.assert_array_equal(to_numpy_u32(t.words), np.asarray(j.words))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))


def str_counts(counter):
    return {str(k): v for k, v in counter.items()}


@pytest.mark.parametrize("length", [0, 1, 16, 17, 1024])
def test_lanes_for_length_matches_jax(length):
    assert tconst.NT_PER_LANE == jconst.NT_PER_LANE == 16
    assert (tconst.lanes_for_length(length)
            == jconst.lanes_for_length(length))


class TestPackedBatch:
    def test_roundtrip_decode(self, seqs):
        t, j = both(seqs)
        assert_same(t, j)
        assert t.decode() == j.decode() == seqs
        assert t.words.device.type == "cpu"

    def test_words_match_oracle(self, seqs):
        from shortseq_torch import oracle

        b = st.pack_batch(seqs, device="cpu")
        words = to_numpy_u32(b.words)
        for i, s in enumerate(seqs):
            lanes = oracle.blocks_to_lanes(
                oracle.encode_bytes(s.encode()), b.width_lanes)
            assert list(words[i]) == lanes

    @pytest.mark.parametrize("width", [None, 64, 112])
    def test_explicit_width(self, seqs, width):
        t, j = both(seqs, width)
        assert_same(t, j)
        assert t.decode() == seqs

    def test_to_objects(self, seqs):
        objs = st.pack_batch(seqs, device="cpu").to_objects()
        for s, o in zip(seqs, objs):
            assert o == st.pack(s)
            assert str(o) == s

    def test_to_objects_odd_lane_width(self):
        seqs = ["ACG" * 5, "T" * 16]  # width 16 -> one lane
        t, j = both(seqs)
        assert [str(o) for o in t.to_objects()] == seqs
        assert [str(o) for o in j.to_objects()] == seqs

    def test_to_objects_pure_python(self, seqs, monkeypatch):
        from shortseq_torch import _build

        monkeypatch.setattr(_build, "load_objects", lambda: None)
        objs = st.pack_batch(seqs, device="cpu").to_objects()
        assert [str(o) for o in objs] == seqs
        assert all(len(o) == len(s) for o, s in zip(objs, seqs))

    def test_hamming_rows(self, rng):
        a = [rand_sequence(rng, 40) for _ in range(20)]
        b = [rand_sequence(rng, 40) for _ in range(20)]
        (ta, ja), (tb_, jb_) = both(a), both(b)
        dist = ta.hamming(tb_)
        assert dist.dtype == torch.int32
        np.testing.assert_array_equal(dist.numpy(), np.asarray(ja.hamming(jb_)))
        for i in range(20):
            assert dist[i] == sum(x != y for x, y in zip(a[i], b[i]))

    def test_hamming_row_views(self, rng):
        # Row slices 1 row off the base (40 B at 150 nt: off 16-byte
        # alignment, the kernel's 4-byte instance on the card).
        a = [rand_sequence(rng, 150) for _ in range(41)]
        b = [s[:70] + rand_sequence(rng, 10) + s[80:] for s in a]
        (ta, ja), (tb_, jb_) = both(a), both(b)
        dist = ta[1:].hamming(tb_[1:])
        assert tuple(dist.shape) == (40,)
        np.testing.assert_array_equal(dist.numpy(),
                                      np.asarray(ja[1:].hamming(jb_[1:])))
        for i in range(40):
            assert dist[i] == sum(x != y for x, y in zip(a[i + 1], b[i + 1]))

    def test_hamming_length_mismatch_raises(self):
        with pytest.raises(Exception, match="equal length"):
            st.pack_batch(["ACGT"], device="cpu").hamming(
                st.pack_batch(["ACG"], device="cpu"))

    def test_pairwise(self, rng):
        seqs = [rand_sequence(rng, 24) for _ in range(15)]
        t, j = both(seqs)
        d = t.pairwise().numpy()
        np.testing.assert_array_equal(d, np.asarray(j.pairwise()))
        assert (np.diag(d) == 0).all()
        assert d[2, 7] == sum(x != y for x, y in zip(seqs[2], seqs[7]))
        other = both(seqs[:4])
        np.testing.assert_array_equal(t.pairwise(other[0]).numpy(),
                                      np.asarray(j.pairwise(other[1])))

    def test_trim_matches_python_slice(self, rng):
        seqs = [rand_sequence(rng, rng.randint(10, 50)) for _ in range(25)]
        t, j = both(seqs)
        tt, jt = t.trim(5, 12), j.trim(5, 12)
        assert_same(tt, jt)
        assert tt.decode() == [s[5:17] for s in seqs]

    def test_trim_clamps_short_rows(self):
        t, j = both(["ACGTACGT", "ACG"])
        assert t.trim(2, 4).decode() == ["GTAC", "G"]
        assert_same(t.trim(2, 4), j.trim(2, 4))

    def test_trim_funnel_shift_fuzz(self, rng):
        seqs = [rand_sequence(rng, rng.randint(0, 200)) for _ in range(48)]
        t, j = both(seqs)
        cases = [(0, 10), (3, 17), (16, 16), (5, 200), (33, 7),
                 (100, 50), (199, 10), (250, 5), (15, 1), (31, 33)]
        for start, length in cases:
            got = t.trim(start, length)
            assert got.decode() == [s[start:start + length] for s in seqs], \
                (start, length)
        # Bit for bit against the JAX package at a handful of pairs (each
        # pair compiles once on the JAX side).
        for start, length in cases[:4]:
            assert_same(t.trim(start, length), j.trim(start, length))

    def test_trim_ragged_fuzz(self, rng):
        # Per-row starts and lengths against the string oracle; the words
        # must be canonical (tail bits zero): re-packing the sliced
        # strings reproduces them bit for bit.
        seqs = [rand_sequence(rng, rng.randint(0, 200)) for _ in range(64)]
        t, j = both(seqs)
        for trial in range(6):
            starts = np.array([rng.randint(0, 210) for _ in seqs], np.int32)
            lengths = np.array([rng.randint(0, 210) for _ in seqs], np.int32)
            got = t.trim_ragged(starts, lengths)
            want = [s[a:a + n] for s, a, n in zip(seqs, starts, lengths)]
            assert got.decode() == want, trial
            canon = st.PackedBatch.from_seqs(want, width=t.width_lanes * 16,
                                             device="cpu")
            assert torch.equal(got.words, canon.words), trial
            assert torch.equal(got.lengths, canon.lengths), trial
            if trial < 2:
                assert_same(got, j.trim_ragged(starts, lengths))

    def test_trim_ragged_scalar_broadcast_and_out_width(self, rng):
        seqs = [rand_sequence(rng, rng.randint(5, 60)) for _ in range(16)]
        t, j = both(seqs)
        assert t.trim_ragged(3, 12).decode() == t.trim(3, 12).decode()
        assert_same(t.trim_ragged(3, 12), j.trim_ragged(3, 12))
        got = t.trim_ragged([1] * 16, [200] * 16, out_width_lanes=1)
        assert got.width_lanes == 1
        assert got.decode() == [s[1:1 + 200][:16] for s in seqs]
        assert_same(got, j.trim_ragged([1] * 16, [200] * 16,
                                       out_width_lanes=1))
        with pytest.raises(ValueError, match="out_width_lanes"):
            t.trim_ragged(0, 1, out_width_lanes=0)

    def test_trim_rejects_negative(self):
        b = st.pack_batch(["ACGT"], device="cpu")
        with pytest.raises(ValueError):
            b.trim(-1, 2)
        with pytest.raises(ValueError):
            b.trim(1, -2)

    def test_counts(self, rng):
        seqs = [rand_sequence(rng, 20) for _ in range(30)]
        seqs += seqs[:12]
        t, j = both(seqs)
        counts = t.counts()
        assert isinstance(counts, st.ShortSeqCounter)
        assert str_counts(counts) == dict(collections.Counter(seqs))
        assert str_counts(counts) == str_counts(j.counts())

    def test_counts_odd_lane_width(self):
        t, j = both(["ACGTACGT", "TTTTAAAA", "ACGTACGT"])
        want = {"ACGTACGT": 2, "TTTTAAAA": 1}
        assert str_counts(t.counts()) == str_counts(j.counts()) == want

    def test_counts_wide_rows(self, rng):
        # W = 8 > 6 lanes: both tables are in the row hash's order, so the
        # dicts agree in order too.
        seqs = [rand_sequence(rng, rng.randint(100, 128)) for _ in range(20)]
        seqs = seqs * 2 + seqs[:5]
        t, j = both(seqs)
        assert t.width_lanes == 8
        got = list(str_counts(t.counts()).items())
        assert got == list(str_counts(j.counts()).items())
        assert dict(got) == dict(collections.Counter(seqs))

    def test_invalid_base_raises(self):
        with pytest.raises(Exception, match="Unsupported base character: N"):
            st.pack_batch(["ACGT", "ACNT"], device="cpu")
        with pytest.raises(Exception, match="Unsupported base character: a"):
            st.pack_batch(["acgt"], device="cpu")

    def test_too_long_and_narrow_width_raise(self):
        with pytest.raises(Exception, match="longer than 1024"):
            st.pack_batch(["A" * 1025], device="cpu")
        with pytest.raises(ValueError, match="multiple of 16"):
            st.pack_batch(["ACGT"], width=20, device="cpu")
        with pytest.raises(ValueError, match="too small"):
            st.pack_batch(["A" * 40], width=32, device="cpu")

    def test_empty_batch(self):
        t, j = both([])
        assert len(t) == 0 and t.decode() == [] and t.counts() == {}
        assert tuple(t.words.shape) == tuple(np.asarray(j.words).shape)

    def test_row_selection(self, seqs):
        b = st.pack_batch(seqs, device="cpu")
        assert b[3:7].decode() == seqs[3:7]
        assert b[5].decode() == [seqs[5]]
        assert b[-1].decode() == [seqs[-1]]
        idx = np.array([8, 0, 8, 36])
        assert b[idx].decode() == [seqs[i] for i in idx]
        j = sq.pack_batch(seqs)
        for item in (slice(None, None, -1), slice(30, 2, -3),
                     slice(1, None, 4)):
            assert b[item].decode() == j[item].decode() == seqs[item]
        with pytest.raises(IndexError):
            b[37]

    def test_from_matrix_roundtrip(self, tmp_path, rng):
        from shortseq_torch.io.fastq import read_fastq_matrix

        reads = [rand_sequence(rng, rng.randint(8, 40)) for _ in range(50)]
        path = tmp_path / "t.fq"
        with open(path, "wb") as f:
            for i, r in enumerate(reads):
                f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n".encode())
        mat, lengths = read_fastq_matrix(path)
        t = st.PackedBatch.from_matrix(mat, lengths, device="cpu")
        assert t.decode() == reads
        assert_same(t, jbatch.PackedBatch.from_matrix(mat, lengths))
        # Columns not a multiple of 16 are zero-padded; zero packs to 'A'.
        narrow = np.ascontiguousarray(mat[:, :40])
        t = st.PackedBatch.from_matrix(narrow, lengths, device="cpu")
        assert t.width_lanes == 3 and t.decode() == reads
        assert_same(t, jbatch.PackedBatch.from_matrix(narrow, lengths))

    def test_cuda_without_card_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="CUDA"):
            st.pack_batch(["ACGT"])
        with pytest.raises(RuntimeError, match="CUDA"):
            st.PackedBatch.from_matrix(np.full((1, 16), 65, np.uint8), [4])


# --- kernel F's wrappers against the JAX functions ----------------------------


def _trim_inputs(seed, n=200, w=10):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 16 * w + 1, size=n).astype(np.int32)
    words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(
        np.uint32)
    # Canonical words: zero past each row's length.
    lane = np.arange(w)[None, :]
    keep = np.clip(lengths[:, None] - 16 * lane, 0, 16)
    mask = np.where(keep >= 16, 0xFFFFFFFF,
                    (1 << (2 * keep.astype(np.uint64))) - 1).astype(np.uint32)
    return words & mask, lengths


@pytest.mark.parametrize("start,length", [(0, 160), (8, 100), (17, 3),
                                          (31, 200), (150, 20)])
def test_trim_words_matches_jax(start, length):
    words, lengths = _trim_inputs(start + length)
    out_w = max(tconst.lanes_for_length(min(length, 160)), 1)
    want = jbatch._trim_words(words, lengths, start, length, out_w)
    for fn in (tbatch.trim_words, tbatch.trim_words_plain):
        got = fn(from_numpy_u32(words), torch.from_numpy(lengths), start,
                 length, out_w)
        np.testing.assert_array_equal(to_numpy_u32(got[0]),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("out_w", [1, 4, 10, 12])
def test_trim_words_ragged_matches_jax(out_w):
    words, lengths = _trim_inputs(out_w, n=300)
    rng = np.random.default_rng(out_w + 1)
    starts = rng.integers(-20, 180, size=300).astype(np.int32)
    new_len = rng.integers(-5, 200, size=300).astype(np.int32)
    starts[:16] = np.arange(16)       # every bit shift, including 0
    want = jbatch._trim_words_ragged(words, lengths, starts, new_len, out_w)
    args = (from_numpy_u32(words), torch.from_numpy(lengths),
            torch.from_numpy(starts), torch.from_numpy(new_len), out_w)
    for fn in (tbatch.trim_words_ragged, tbatch.trim_words_ragged_plain):
        got = fn(*args)
        np.testing.assert_array_equal(to_numpy_u32(got[0]),
                                      np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("start", [0, 15, 16, 17, 40])
def test_trim_words_scalar_mode_matches_jax(start):
    # trim_words hands kernel F a scalar start and length (on the CPU the
    # plain version); out_w 12 > W = 10 keeps lanes past the source.
    words, lengths = _trim_inputs(start)
    for length in (0, 1, 16, 33, 100, 150):
        for out_w in (max(tconst.lanes_for_length(length), 1), 12):
            want = jbatch._trim_words(words, lengths, start, length, out_w)
            got = tbatch.trim_words(from_numpy_u32(words),
                                    torch.from_numpy(lengths), start, length,
                                    out_w)
            np.testing.assert_array_equal(to_numpy_u32(got[0]),
                                          np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(),
                                          np.asarray(want[1]))


def test_trim_ragged_int_arguments_equal_tensor_form():
    words, lengths = _trim_inputs(3, n=300)
    w, ln = from_numpy_u32(words), torch.from_numpy(lengths)
    per = np.random.default_rng(4).integers(0, 160, size=300).astype(np.int32)
    for start, length in ((0, 160), (17, 90), (-4, 33), (200, 5),
                          (3, 2**40), (-2**40, 7)):
        for out_w in (1, 7, 12):
            tensors = [torch.from_numpy(np.full(300, np.clip(
                v, -2**31, 2**31 - 1), np.int32)) for v in (start, length)]
            want = tbatch.trim_words_ragged(w, ln, *tensors, out_w)
            for args in ((start, length), (tensors[0], length),
                         (start, tensors[1])):
                got = tbatch.trim_words_ragged(w, ln, *args, out_w)
                assert torch.equal(got[0], want[0]) and \
                    torch.equal(got[1], want[1]), (start, length, out_w)
        got = tbatch.trim_words_ragged(w, ln, torch.from_numpy(per), length,
                                       10)
        want = tbatch.trim_words_ragged(
            w, ln, torch.from_numpy(per), tensors[1], 10)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    b = st.PackedBatch(w, ln)
    for start, length in ((3, 12), (np.int32(40), np.int64(100))):
        got = b.trim_ragged(start, length)
        want = b.trim_ragged([int(start)] * 300, [int(length)] * 300)
        assert torch.equal(got.words, want.words)
        assert torch.equal(got.lengths, want.lengths)


def test_trim_words_ragged_rejects_bad_shapes():
    w = torch.zeros((3, 2), dtype=torch.int32)
    v = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="starts"):
        tbatch.trim_words_ragged(w, v, v[:2], v, 1)
    with pytest.raises(ValueError, match="out_w"):
        tbatch.trim_words_ragged(w, v, v, v, 0)


# --- table_to_counter ---------------------------------------------------------


def test_table_to_counter_raises_on_overflow_and_poison():
    from shortseq_torch.api.counter import table_to_counter
    from shortseq_torch.count.device import unique_count

    words = torch.tensor([[1, 0], [2, 0], [1, 0]], dtype=torch.int32)
    lengths = torch.full((3,), 20, dtype=torch.int32)
    ones = torch.ones(3, dtype=torch.int32)
    c = table_to_counter(unique_count(words, lengths, ones))
    assert sorted(c.values()) == [1, 2]
    with pytest.raises(ValueError, match="overflow"):
        table_to_counter(unique_count(words, lengths, ones, n_out=1))
    with pytest.raises(OverflowError):
        table_to_counter(unique_count(words, lengths,
                                      torch.tensor([1, -1, 1],
                                                   dtype=torch.int32)))


# --- on the card --------------------------------------------------------------


def test_batch_on_card_matches_cpu(cuda, rng):
    from shortseq_torch.ops import bitpack, hamming

    seqs = [rand_sequence(rng, rng.randint(0, 200)) for _ in range(500)]
    t = st.pack_batch(seqs, device="cuda")
    c = st.pack_batch(seqs, device="cpu")
    assert torch.equal(t.words.cpu(), c.words)
    before = (bitpack.unpack_ascii.launches,
              tbatch.trim_words_ragged.launches, hamming.hamming_rows.launches)
    assert t.decode() == seqs
    for start, length in ((0, 10), (8, 100), (33, 7), (199, 10)):
        got = t.trim(start, length)
        want = c.trim(start, length)
        assert torch.equal(got.words.cpu(), want.words)
        assert torch.equal(got.lengths.cpu(), want.lengths)
    starts = np.array([rng.randint(-3, 210) for _ in seqs], np.int32)
    lengths = np.array([rng.randint(0, 210) for _ in seqs], np.int32)
    got, want = t.trim_ragged(starts, lengths), c.trim_ragged(starts, lengths)
    assert torch.equal(got.words.cpu(), want.words)
    assert torch.equal(got.lengths.cpu(), want.lengths)
    same = st.pack_batch([s[::-1] for s in seqs], device="cuda")
    assert torch.equal(t.hamming(same).cpu(),
                       c.hamming(st.pack_batch([s[::-1] for s in seqs],
                                               device="cpu")))
    assert (bitpack.unpack_ascii.launches, tbatch.trim_words_ragged.launches,
            hamming.hamming_rows.launches) == (before[0] + 1, before[1] + 5,
                                               before[2] + 1)
    assert str_counts(t.counts()) == str_counts(c.counts())
    assert [str(o) for o in t.to_objects()] == seqs
    with pytest.raises(Exception, match="Unsupported base character: N"):
        st.pack_batch(["ACGT", "ACNT"], device="cuda")


@pytest.mark.parametrize("out_w", [1, 3, 10, 64])
def test_trim_kernel_matches_plain_on_card(cuda, out_w):
    words, lengths = _trim_inputs(out_w + 5, n=5000, w=64)
    rng = np.random.default_rng(out_w)
    starts = rng.integers(-20, 1100, size=5000).astype(np.int32)
    new_len = rng.integers(-5, 1100, size=5000).astype(np.int32)
    args = [from_numpy_u32(words), torch.from_numpy(lengths),
            torch.from_numpy(starts), torch.from_numpy(new_len)]
    args = [a.to(cuda) for a in args]
    got = tbatch.trim_words_ragged(*args, out_w)
    want = tbatch.trim_words_ragged_plain(*args, out_w)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,w", [(1, 10), (1001, 10), (4097, 3), (300, 64)])
def test_trim_kernel_scalar_and_ragged_on_card(cuda, n, w):
    # Starts past the row, length 0, starts on lane edges (16, 32) and
    # beside one (15, 17), out_w > W, N = 1 and N off the block's rows,
    # and words off 16-byte alignment (a row slice): scalar and ragged
    # modes against the plain version, one launch a call.
    words, lengths = _trim_inputs(n + w, n=n + 1, w=w)
    full = from_numpy_u32(words).to(cuda)
    lens = torch.from_numpy(lengths).to(cuda)
    rng = np.random.default_rng(n)
    for wd, ln in ((full[:n], lens[:n]), (full[1:], lens[1:])):
        for start, length in ((0, 16 * w), (15, 100), (16, 0), (17, 40),
                              (32, 1000), (16 * w + 3, 5)):
            for out_w in (1, w, w + 2):
                before = tbatch.trim_words_ragged.launches
                got = tbatch.trim_words(wd, ln, start, length, out_w)
                assert tbatch.trim_words_ragged.launches == before + 1
                want = tbatch.trim_words_plain(wd, ln, start, length, out_w)
                assert torch.equal(got[0], want[0]), (start, length, out_w)
                assert torch.equal(got[1], want[1]), (start, length, out_w)
        starts = torch.from_numpy(rng.integers(-3, 16 * w + 8, size=n)
                                  .astype(np.int32)).to(cuda)
        keep = torch.from_numpy(rng.integers(-2, 16 * w + 8, size=n)
                                .astype(np.int32)).to(cuda)
        for out_w in (1, w, w + 2):
            for s, k in ((starts, keep), (17, keep), (starts, 40)):
                got = tbatch.trim_words_ragged(wd, ln, s, k, out_w)
                sp = s if isinstance(s, torch.Tensor) else torch.full_like(
                    keep, s)
                kp = k if isinstance(k, torch.Tensor) else torch.full_like(
                    keep, k)
                want = tbatch.trim_words_ragged_plain(wd, ln, sp, kp, out_w)
                assert torch.equal(got[0], want[0]) and \
                    torch.equal(got[1], want[1])
