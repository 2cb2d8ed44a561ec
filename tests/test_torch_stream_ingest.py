"""The streamed count's ingest in shortseq_torch: a plain file's slices
read one after another into one host buffer of the call and indexed
where they lie there (io.fastq.slice_buffer, read_fastq_slice).

A file of at least 4 slices, cut mid-record, must count to the tables of
the whole-file path and of shortseq_tpu, array for array, on both engines
(the device engine on device="cpu"); its last slice is the shortest, so
bytes of the slice before it are left past its end in the buffer.  An
invalid base in the third slice raises the reference's message.  The
buffer's counters read one alloc and a reuse for every later slice."""

import numpy as np
import pytest

import shortseq_torch as st
import shortseq_torch.io.native as tn
import shortseq_tpu as sq
from shortseq_torch.io import fastq as tfastq

ALPHA = np.frombuffer(b"ACGT", np.uint8)
ENGINES = ("device", "host")
STREAM_BYTES = 40_000


def _reads(seed, n=900):
    """Reads of 0-200 nt drawn from a pool (repeats count above 1), in
    all three width buckets."""
    rng = np.random.default_rng(seed)
    pool = [ALPHA[rng.integers(0, 4, size=int(k))].tobytes().decode()
            for k in rng.integers(0, 201, size=150)]
    return [pool[i] for i in rng.integers(0, len(pool), size=n)]


def _write(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


def _slices(path):
    """The streamed call's (lo, hi) slices of `path`."""
    import os

    size = os.path.getsize(path)
    n = -(-size // STREAM_BYTES)
    return [(s * size // n, (s + 1) * size // n) for s in range(n)]


def _arrays(table):
    """Each bucket's live (words, lengths, counts) as host arrays."""
    out = []
    for b in table._buckets:
        n = b.n_unique
        out.append(tuple(np.asarray(a[:n]) for a in
                         (b.words, b.lengths, b.counts)))
    return out


def _assert_same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.view(np.int32) if a.dtype ==
                                          np.uint32 else a,
                                          b.view(np.int32) if b.dtype ==
                                          np.uint32 else b)


@pytest.fixture
def streamed_file(tmp_path, monkeypatch):
    """A FASTQ of at least 4 slices whose cuts fall inside records and
    whose last slice reads the fewest bytes."""
    path = _write(tmp_path / "s.fastq", _reads(11))
    slices = _slices(path)
    assert len(slices) >= 4
    data = open(path, "rb").read()
    for lo, _ in slices[1:]:
        assert tfastq.fastq_sync(data, lo) != lo   # a cut inside a record
    reads = [np.subtract(*tfastq._range_bounds(path, lo, hi)[::-1])
             for lo, hi in slices]
    assert reads[-1] < min(reads[:-1])
    monkeypatch.setenv("SHORTSEQ_TORCH_STREAM_BYTES", str(STREAM_BYTES))
    monkeypatch.setenv("SHORTSEQ_TPU_STREAM_BYTES", str(STREAM_BYTES))
    return path


@pytest.mark.parametrize("engine", ENGINES)
def test_slices_count_as_the_whole_file(streamed_file, monkeypatch,
                                        engine):
    import shortseq_torch.api.counter as tcounter

    taken = []
    real = tcounter._read_and_count_table_streamed
    monkeypatch.setattr(tcounter, "_read_and_count_table_streamed",
                        lambda *a: taken.append(a) or real(*a))
    streamed = st.read_and_count_fastq_table(streamed_file, engine=engine,
                                             device="cpu")
    assert len(taken) == 1
    want = sq.read_and_count_fastq_table(streamed_file, engine=engine)
    _assert_same_arrays(_arrays(streamed), _arrays(want))
    monkeypatch.delenv("SHORTSEQ_TORCH_STREAM_BYTES")
    whole = st.read_and_count_fastq_table(streamed_file, engine=engine,
                                          device="cpu")
    _assert_same_arrays(_arrays(streamed), _arrays(whole))
    assert streamed.total() == whole.total() == 900


@pytest.mark.parametrize("engine", ENGINES)
def test_invalid_base_in_the_third_slice(tmp_path, monkeypatch, engine):
    reads = _reads(12)
    path = _write(tmp_path / "bad.fastq", reads)
    lo, hi = _slices(path)[2]
    data = open(path, "rb").read()
    # The first sequence line that starts inside the third slice.
    at = data.index(b"\n@read", lo) + 1
    seq = data.index(b"\n", at) + 1
    while data[seq:seq + 1] == b"\n":             # an empty read: the next
        at = data.index(b"\n@read", seq) + 1
        seq = data.index(b"\n", at) + 1
    assert seq < hi
    bad = bytearray(data)
    bad[seq] = ord("N")
    open(path, "wb").write(bytes(bad))
    msgs = []
    for stream in (str(STREAM_BYTES), None):
        if stream:
            monkeypatch.setenv("SHORTSEQ_TORCH_STREAM_BYTES", stream)
        else:
            monkeypatch.delenv("SHORTSEQ_TORCH_STREAM_BYTES")
        with pytest.raises(Exception, match="Unsupported base") as info:
            st.read_and_count_fastq_table(path, engine=engine,
                                          device="cpu")
        msgs.append(str(info.value))
    with pytest.raises(Exception, match="Unsupported base") as info:
        sq.read_and_count_fastq_table(path, engine=engine)
    assert msgs == [str(info.value)] * 2 == \
        ["Unsupported base character: N"] * 2


@pytest.mark.parametrize("engine", ENGINES)
def test_buffer_counters(streamed_file, monkeypatch, engine):
    sb = tfastq.slice_buffer
    before = (sb.allocs, sb.reuses)
    st.read_and_count_fastq_table(streamed_file, engine=engine,
                                  device="cpu")
    n = len(_slices(streamed_file))
    assert (sb.allocs - before[0], sb.reuses - before[1]) == (1, n - 1)
    # A whole-file call reads no slice.
    monkeypatch.delenv("SHORTSEQ_TORCH_STREAM_BYTES")
    before = (sb.allocs, sb.reuses)
    st.read_and_count_fastq_table(streamed_file, engine=engine,
                                  device="cpu")
    assert (sb.allocs, sb.reuses) == before


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_slice_in_a_used_buffer_equals_read_fastq_index(tmp_path,
                                                        monkeypatch,
                                                        native):
    """Each slice read into a buffer whose every byte holds records of
    another file gives read_fastq_index's records: the same lengths and
    the same bytes at its starts, and nothing from past the slice."""
    if not native:
        monkeypatch.setattr(tn, "get_lib", lambda: None)
    path = _write(tmp_path / "r.fastq", _reads(13, n=400))
    junk = b"@j\nACGTACGT\n+\nIIIIIIII\n"
    slices = _slices(path)
    size = len(open(path, "rb").read())
    nbytes = tfastq.slice_buffer_bytes(size, len(slices))
    buf = None
    for lo, hi in reversed(slices):
        buf = tfastq.slice_buffer(buf, nbytes)
        buf[:] = np.frombuffer((junk * (nbytes // len(junk) + 1))[:nbytes],
                               np.uint8)
        data, starts, lengths = tfastq.read_fastq_slice(path, (lo, hi), buf)
        want, w_starts, w_lengths = tfastq.read_fastq_index(
            path, byte_range=(lo, hi))
        np.testing.assert_array_equal(lengths, w_lengths)
        got = [bytes(data[s:s + k]) for s, k in zip(starts, lengths)]
        assert got == [want[s:s + k] for s, k in zip(w_starts, w_lengths)]
        if native:
            assert np.shares_memory(data, buf)


@pytest.mark.parametrize("case", ["small_buffer", "n_past_buffer",
                                  "wide_dtype"])
def test_buffer_that_cannot_hold_the_slice_raises(tmp_path, case):
    path = _write(tmp_path / "r.fastq", _reads(14, n=100))
    size = len(open(path, "rb").read())
    if case == "small_buffer":
        with pytest.raises(ValueError, match="does not fit"):
            tfastq.read_fastq_slice(path, (0, size),
                                    np.empty(size - 1, np.uint8))
    elif case == "n_past_buffer":
        with pytest.raises(ValueError):
            tn.fastq_index_in_place(np.empty(10, np.uint8), 11, (0, 11))
    else:
        with pytest.raises(ValueError):
            tn.fastq_index_in_place(np.empty(10, np.int32), 8, (0, 8))
