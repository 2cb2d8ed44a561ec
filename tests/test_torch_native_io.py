"""shortseq_torch.io's byte-range matrix reader and host packing oracle
against shortseq_tpu's: read_fastq_matrix / fastq_matrix_native with
byte_range=(lo, hi) on plain and BGZF files, and pack_rows_native
(tests/test_native_io.py's cases)."""

import numpy as np
import pytest

import shortseq_torch.io.native as tn
import shortseq_tpu.io.native as jn
from shortseq_torch.io.fastq import read_fastq_matrix
from shortseq_tpu.io.fastq import read_fastq_matrix as jax_matrix
from tests.test_bgzf import bgzf_compress

ALPHA = np.frombuffer(b"ACGT", np.uint8)


def _write(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i}_{'x' * (i % 7)}\n{r}\n+\n{'I' * len(r)}\n")


def _reads(seed, n=240):
    rng = np.random.default_rng(seed)
    return [ALPHA[rng.integers(0, 4, size=int(k))].tobytes().decode()
            for k in rng.integers(0, 120, size=n)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_smallest_input_full_range(tmp_path, monkeypatch, native):
    path = tmp_path / "one.fastq"
    path.write_bytes(b"@r\nACGT\n+\nIIII\n")
    if not native:
        monkeypatch.setattr(tn, "fastq_matrix_native", lambda *a, **k: None)
    mat, lengths = read_fastq_matrix(path, byte_range=(0, 15))
    want = jax_matrix(path, byte_range=(0, 15))
    assert mat.shape == (1, 16) and lengths.tolist() == [4]
    np.testing.assert_array_equal(mat, want[0])
    np.testing.assert_array_equal(lengths, want[1])


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("compress", ["plain", "bgzf"])
def test_three_ranges_union_is_whole_file(tmp_path, monkeypatch, compress,
                                          native):
    reads = _reads(1)
    path = tmp_path / "r.fastq"
    _write(path, reads)
    if compress == "bgzf":
        path.write_bytes(bgzf_compress(path.read_bytes(), block=900))
    if not native:
        monkeypatch.setattr(tn, "fastq_matrix_native", lambda *a, **k: None)
        monkeypatch.setattr(jn, "fastq_matrix_native", lambda *a, **k: None)
    size = path.stat().st_size
    cuts = [0, size // 3, 2 * size // 3, size]
    got = []
    for lo, hi in zip(cuts, cuts[1:]):
        mat, lengths = read_fastq_matrix(path, pad_to=16, byte_range=(lo, hi))
        want = jax_matrix(path, pad_to=16, byte_range=(lo, hi))
        np.testing.assert_array_equal(mat, want[0])
        np.testing.assert_array_equal(lengths, want[1])
        got += [bytes(mat[i, :lengths[i]]).decode()
                for i in range(len(lengths))]
    assert got == reads
    whole, whole_len = read_fastq_matrix(path)
    assert [bytes(whole[i, :whole_len[i]]).decode()
            for i in range(len(whole_len))] == reads


def test_fastq_matrix_native_byte_range_matches_jax(tmp_path):
    reads = _reads(2)
    path = tmp_path / "r.fastq"
    _write(path, reads)
    data = path.read_bytes()
    n = len(data)
    for rng in [None, (0, n), (n // 4, 3 * n // 4), (n // 2, n // 2)]:
        got = tn.fastq_matrix_native(data, pad_to=16, byte_range=rng)
        want = jn.fastq_matrix_native(data, pad_to=16, byte_range=rng)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_pack_rows_matches_jax_and_oracle():
    from shortseq_torch import oracle

    rng = np.random.default_rng(3)
    seqs = [ALPHA[rng.integers(0, 4, size=int(k))].tobytes()
            for k in rng.integers(1, 65, size=64)]
    mat = np.zeros((len(seqs), 64), np.uint8)
    lengths = np.array([len(s) for s in seqs], np.int32)
    for i, s in enumerate(seqs):
        mat[i, :len(s)] = np.frombuffer(s, np.uint8)
    words = tn.pack_rows_native(mat, lengths)
    np.testing.assert_array_equal(words, jn.pack_rows_native(mat, lengths))
    for i, s in enumerate(seqs):
        assert list(words[i]) == oracle.blocks_to_lanes(
            oracle.encode_bytes(s), 4)
    one = tn.pack_rows_native(
        np.frombuffer(b"ACGT" * 4, np.uint8).reshape(1, 16),
        np.array([16], np.int32))
    np.testing.assert_array_equal(one, jn.pack_rows_native(
        np.frombuffer(b"ACGT" * 4, np.uint8).reshape(1, 16),
        np.array([16], np.int32)))


def test_pack_rows_rejects_bad_base_like_jax():
    mat = np.zeros((3, 16), np.uint8)
    mat[0, :4] = np.frombuffer(b"ACGT", np.uint8)
    mat[1, :4] = np.frombuffer(b"ACGT", np.uint8)
    mat[2, :4] = np.frombuffer(b"ACNT", np.uint8)
    lengths = np.array([4, 4, 4], np.int32)
    msgs = []
    for fn in (tn.pack_rows_native, jn.pack_rows_native):
        with pytest.raises(Exception, match="Unsupported base character") \
                as info:
            fn(mat, lengths)
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "Unsupported base character in read 2"


def test_pack_rows_without_library(monkeypatch):
    monkeypatch.setattr(tn, "get_lib", lambda: None)
    assert tn.pack_rows_native(np.zeros((1, 16), np.uint8),
                               np.array([0], np.int32)) is None
