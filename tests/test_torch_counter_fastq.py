"""shortseq_torch's read_and_count_fastq(_table), its ingest, and the
`count` and `pack` CLI against shortseq_tpu on the same files.  Host and
device engines; the port's device engine runs on device="cpu" here
(torch.sort + the plain versions of kernels A and D).  Mirrors
tests/test_counter_fastq.py, tests/test_streaming_ingest.py and
tests/test_cli.py.

Dict insertion order, and so the order of the CLI's equal-count lines, is
the table order: identical for the host engine everywhere and for the
device engine on reads of at most 96 nt; the JAX device engine's 64-lane
bucket is in hash order, so there the comparison is of contents."""

import collections
import gzip
import json

import numpy as np
import pytest

import shortseq_torch as st
import shortseq_torch.api.counter as tcounter
import shortseq_tpu as sq
from shortseq_torch.__main__ import main as torch_main
from shortseq_tpu.__main__ import main as jax_main
from tests.test_bgzf import bgzf_compress

ALPHA = np.frombuffer(b"ACGT", np.uint8)


def _reads(seed, n=400, buckets=((0, 32), (33, 96), (97, 200)), pool=120):
    rng = np.random.default_rng(seed)
    seqs = []
    for lo, hi in buckets:
        for k in rng.integers(lo, hi + 1, size=pool // len(buckets)):
            seqs.append(ALPHA[rng.integers(0, 4, size=int(k))].tobytes()
                        .decode())
    return [seqs[i] for i in rng.integers(0, len(seqs), size=n)]


def _write(path, reads):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@read{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


def _items(counter):
    return [(str(k), v) for k, v in counter.items()]


NARROW = ((0, 32), (33, 96))
WIDE = ((0, 32), (33, 96), (97, 200))


@pytest.mark.parametrize("engine", ["host", "device", "auto"])
@pytest.mark.parametrize("buckets", [NARROW, WIDE], ids=["narrow", "mixed"])
def test_read_and_count_matches_jax(tmp_path, capsys, engine, buckets):
    reads = _reads(1, buckets=buckets) + ["", ""]
    path = _write(tmp_path / "r.fastq", reads)
    got = st.read_and_count_fastq(path, engine=engine, device="cpu")
    want = sq.read_and_count_fastq(path, engine=engine)
    assert {str(k): v for k, v in got.items()} == \
        dict(collections.Counter(reads))
    if engine != "device" or buckets == NARROW:
        assert _items(got) == _items(want)
    else:
        assert sorted(_items(got)) == sorted(_items(want))
    out = capsys.readouterr().out.splitlines()
    assert all("total seqs" in line and "unique sequences" in line
               for line in out) and len(out) == 2
    for k in got:
        assert type(k).__name__ == ("ShortSeq64" if len(k) <= 32 else
                                    "ShortSeq192" if len(k) <= 96 else
                                    "ShortSeqVar")
        assert got[st.pack(str(k))] == got[k]


@pytest.mark.parametrize("engine", ["host", "device"])
def test_invalid_base_message_matches_jax(tmp_path, engine):
    path = _write(tmp_path / "bad.fastq", ["ACGT", "ACNT", "GGGG"])
    msgs = []
    for fn in (lambda: st.read_and_count_fastq(path, engine=engine,
                                               device="cpu"),
               lambda: sq.read_and_count_fastq(path, engine=engine)):
        with pytest.raises(Exception, match="Unsupported base") as info:
            fn()
        msgs.append(str(info.value))
    assert msgs[0] == msgs[1] == "Unsupported base character: N"


@pytest.mark.parametrize("engine", ["host", "device"])
def test_gzip_transparent(tmp_path, engine):
    reads = _reads(2, buckets=NARROW)
    plain = _write(tmp_path / "t.fastq", reads)
    gz = tmp_path / "t.fastq.gz"
    gz.write_bytes(gzip.compress(open(plain, "rb").read()))
    got = st.read_and_count_fastq(str(gz), engine=engine, device="cpu")
    assert got == st.read_and_count_fastq(plain, engine=engine,
                                          device="cpu")
    assert _items(got) == _items(sq.read_and_count_fastq(str(gz),
                                                         engine=engine))


@pytest.mark.parametrize("compress", ["plain", "bgzf"])
@pytest.mark.parametrize("engine", ["host", "device"])
def test_streamed_equals_whole_file(tmp_path, monkeypatch, engine,
                                    compress):
    reads = _reads(3, n=1500)
    path = tmp_path / "s.fastq"
    _write(path, reads)
    if compress == "bgzf":
        path.write_bytes(bgzf_compress(path.read_bytes(), block=700))
    taken = []
    real = tcounter._read_and_count_table_streamed
    monkeypatch.setattr(tcounter, "_read_and_count_table_streamed",
                        lambda *a: taken.append(a) or real(*a))
    whole = st.read_and_count_fastq_table(str(path), engine=engine,
                                          device="cpu")
    monkeypatch.setenv("SHORTSEQ_TORCH_STREAM_BYTES", "4096")
    monkeypatch.setenv("SHORTSEQ_TPU_STREAM_BYTES", "4096")
    streamed = st.read_and_count_fastq_table(str(path), engine=engine,
                                             device="cpu")
    assert len(taken) == 1 and taken[0][3] == 4096
    want = sq.read_and_count_fastq_table(str(path), engine=engine)
    assert streamed.total() == len(reads)
    assert streamed.to_counter() == whole.to_counter()
    assert sorted(_items(streamed.to_counter())) == \
        sorted(_items(want.to_counter()))
    assert [(str(k), c) for k, c in streamed.most_common()] == \
        [(str(k), c) for k, c in want.most_common()]


def test_h2d_four_chunk_path(tmp_path, monkeypatch):
    from shortseq_torch.count import device as tdev

    reads = _reads(4, n=900)
    path = _write(tmp_path / "c.fastq", reads)
    whole = st.read_and_count_fastq_table(path, engine="device",
                                          device="cpu")
    calls = []
    real = tdev.unique_count
    monkeypatch.setattr(tdev, "unique_count",
                        lambda *a, **k: calls.append(a[1].shape[0])
                        or real(*a, **k))
    monkeypatch.setenv("SHORTSEQ_TORCH_H2D_CHUNK_ROWS", "64")
    chunked = st.read_and_count_fastq_table(path, engine="device",
                                            device="cpu")
    # Three buckets, each of >= 64 rows: 4 chunk counts + 1 merge each,
    # and the chunks are unequal where the rows do not divide by 4.
    assert len(calls) == 15
    assert chunked.to_counter() == whole.to_counter()
    assert _items(chunked.to_counter()) == _items(whole.to_counter())
    assert chunked.total() == len(reads)


def test_put_lengths_range_guard():
    import torch

    from shortseq_torch.count.device import PAD_LENGTH

    cpu = torch.device("cpu")
    lens = tcounter._put_lengths(
        np.array([0, 1024, 32767, PAD_LENGTH], np.int32), cpu)
    assert lens.tolist() == [0, 1024, 32767, PAD_LENGTH]
    with pytest.raises(ValueError, match="int16"):
        tcounter._put_lengths(np.array([4, 32768], np.int32), cpu)


@pytest.mark.parametrize("buckets", [NARROW, WIDE], ids=["narrow", "mixed"])
def test_count_matrix_device_matches_jax(tmp_path, buckets):
    from shortseq_torch.io.fastq import read_fastq_matrix
    from shortseq_tpu.api.counter import count_matrix_device as jax_cmd

    reads = _reads(5, buckets=buckets) + [""]
    path = _write(tmp_path / "m.fastq", reads)
    mat, lengths = read_fastq_matrix(path)
    got = tcounter.count_matrix_device(mat, lengths, device="cpu")
    want = jax_cmd(mat, lengths)
    assert {str(k): v for k, v in got.items()} == \
        dict(collections.Counter(reads))
    if buckets == NARROW:
        assert _items(got) == _items(want)
    else:
        assert sorted(_items(got)) == sorted(_items(want))
    mat[3, 0] = ord("x")
    lengths = np.maximum(lengths, 1)
    with pytest.raises(Exception, match="Unsupported base character: x"):
        tcounter.count_matrix_device(mat, lengths, device="cpu")


def test_engine_errors(tmp_path, monkeypatch):
    path = _write(tmp_path / "e.fastq", ["ACGT"])
    with pytest.raises(ValueError, match="unknown engine"):
        st.read_and_count_fastq(path, engine="gpu", device="cpu")
    monkeypatch.setattr(tcounter, "count_indexed_host_table",
                        lambda *a: None)
    with pytest.raises(RuntimeError, match="native library"):
        st.read_and_count_fastq(path, engine="host", device="cpu")


@pytest.mark.parametrize("compress", ["plain", "bgzf"])
def test_read_fastq_index_ranges_match_jax(tmp_path, monkeypatch, compress):
    import shortseq_torch.io.native as tn
    from shortseq_torch.io.fastq import read_fastq_index
    from shortseq_tpu.io.fastq import read_fastq_index as jax_index

    path = tmp_path / "r.fastq"
    _write(path, _reads(6, n=300))
    if compress == "bgzf":
        path.write_bytes(bgzf_compress(path.read_bytes(), block=600))
    size = path.stat().st_size
    cuts = [0, size // 3, size // 2, size]
    for lo, hi in [(None, None)] + list(zip(cuts, cuts[1:])):
        rng = None if lo is None else (lo, hi)
        want = jax_index(str(path), byte_range=rng)
        got = read_fastq_index(str(path), byte_range=rng)
        monkeypatch.setattr(tn, "fastq_index_native", lambda *a: None)
        got_py = read_fastq_index(str(path), byte_range=rng)
        monkeypatch.undo()
        for g in (got, got_py):
            assert g[0] == want[0]
            np.testing.assert_array_equal(g[1], want[1])
            np.testing.assert_array_equal(g[2], want[2])


@pytest.mark.parametrize("case", ["normal", "no_final_newline", "empty"])
def test_read_fastq_lines_and_seqs_match_jax(tmp_path, case):
    import shortseq_torch.io as tio
    import shortseq_tpu.io as jio

    path = tmp_path / "r.fastq"
    if case == "normal":
        _write(path, _reads(9, n=100) + [""])
    elif case == "no_final_newline":
        path.write_bytes(b"@r0\nACGT\n+\nIIII\n@r1\nGGCC\n+\nIIII")
    else:
        path.write_bytes(b"")
    lines = tio.read_fastq_lines(path)
    assert lines == jio.read_fastq_lines(path)
    assert len(lines) == {"normal": 101, "no_final_newline": 2,
                          "empty": 0}[case]
    seqs = tio.read_fastq_seqs(path)
    assert [str(s) for s in seqs] == \
        [str(s) for s in jio.read_fastq_seqs(path)] == \
        [b.decode() for b in lines]
    assert all(type(s) in (st.ShortSeq64, st.ShortSeq192, st.ShortSeqVar)
               for s in seqs)
    buf = np.frombuffer(path.read_bytes(), np.uint8)
    if buf.size:
        for a, b in zip(tio.fastq_line_index(buf), jio.fastq_line_index(buf)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("chunk_rows", [None, "256"])
def test_count_indexed_eager_forms_match_jax(tmp_path, monkeypatch,
                                             chunk_rows):
    """count_indexed_device (device="cpu") and count_indexed_host on the
    mixed-width file of tests/test_counter_fastq.py's engine tests, with
    and without the 4-chunk transfer path."""
    import random

    from shortseq_tpu.api.counter import count_indexed_device as jax_device
    from shortseq_tpu.api.counter import count_indexed_host as jax_host
    from shortseq_torch.io.fastq import read_fastq_index

    rng = random.Random(99)

    def rand_read(lo, hi):
        return "".join(rng.choice("ACTG")
                       for _ in range(rng.randint(lo, hi)))

    reads = ([rand_read(1, 32) for _ in range(120)]
             + [rand_read(33, 96) for _ in range(40)]
             + [rand_read(97, 200) for _ in range(20)])
    reads = reads + reads[::3]
    path = _write(tmp_path / "engines.fastq", reads)
    if chunk_rows:
        monkeypatch.setenv("SHORTSEQ_TORCH_H2D_CHUNK_ROWS", chunk_rows)
        monkeypatch.setenv("SHORTSEQ_TPU_H2D_CHUNK_ROWS", chunk_rows)
    data, starts, lengths = read_fastq_index(path)
    oracle = dict(collections.Counter(reads))
    got = tcounter.count_indexed_device(data, starts, lengths, device="cpu")
    want = jax_device(data, starts, lengths)
    assert type(got) is tcounter.ShortSeqCounter
    assert {str(k): v for k, v in got.items()} == \
        {str(k): v for k, v in want.items()} == oracle
    host = tcounter.count_indexed_host(data, starts, lengths)
    assert type(host) is tcounter.ShortSeqCounter
    assert _items(host) == _items(jax_host(data, starts, lengths))
    assert host == got
    monkeypatch.setattr(tcounter, "count_indexed_host_table",
                        lambda *a: None)
    assert tcounter.count_indexed_host(data, starts, lengths) is None


def test_plain_gzip_refuses_byte_range(tmp_path):
    from shortseq_torch.io.fastq import read_fastq_index

    gz = tmp_path / "t.fastq.gz"
    gz.write_bytes(gzip.compress(b"@r\nACGT\n+\nIIII\n"))
    with pytest.raises(ValueError, match="random access"):
        read_fastq_index(str(gz), byte_range=(0, 10))


@pytest.mark.parametrize("width", [32, 96, 1024])
def test_gather_pack_native_numpy_and_jax_agree(width):
    from shortseq_torch.io.fastq import gather_pack, gather_pack_numpy
    from shortseq_tpu.io.fastq import gather_pack as jax_gather_pack

    rng = np.random.default_rng(width)
    reads = [ALPHA[rng.integers(0, 4, size=int(k))].tobytes()
             for k in rng.integers(0, width + 1, size=200)]
    data = b"".join(reads)
    lengths = np.array([len(r) for r in reads], np.int32)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    want = jax_gather_pack(data, starts, lengths, width)
    np.testing.assert_array_equal(gather_pack(data, starts, lengths, width),
                                  want)
    np.testing.assert_array_equal(
        gather_pack_numpy(data, starts, lengths, width), want)


def test_host_count_native_forms():
    from shortseq_torch.io.native import (host_count_native,
                                          host_count_weighted_native)

    rng = np.random.default_rng(3)
    uniq = rng.integers(0, 2**32, size=(300, 3), dtype=np.uint64) \
        .astype(np.uint32)
    ulen = rng.integers(0, 49, size=300).astype(np.int32)
    pick = rng.integers(0, 300, size=5000)
    u_w, u_l, u_c = host_count_native(uniq[pick], ulen[pick])
    ref = collections.Counter((int(l), tuple(map(int, w)))
                              for w, l in zip(uniq[pick], ulen[pick]))
    got = {(int(l), tuple(map(int, w))): int(c)
           for w, l, c in zip(u_w, u_l, u_c)}
    assert got == dict(ref)
    m_w, m_l, m_c = host_count_weighted_native(
        np.concatenate([u_w, u_w]), np.concatenate([u_l, u_l]),
        np.concatenate([u_c, 2 * u_c]))
    assert {(int(l), tuple(map(int, w))): int(c)
            for w, l, c in zip(m_w, m_l, m_c)} == \
        {k: 3 * v for k, v in ref.items()}


# --- CLI ---------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    return {"narrow": _write(d / "narrow.fastq", _reads(7, buckets=NARROW)),
            "mixed": _write(d / "mixed.fastq", _reads(8, buckets=WIDE))}


@pytest.mark.parametrize("extra", [[], ["--json"], ["--top", "5"],
                                   ["--json", "--top", "7"]],
                         ids=["tsv", "json", "top", "json-top"])
@pytest.mark.parametrize("engine", ["auto", "host", "device"])
@pytest.mark.parametrize("name", ["narrow", "mixed"])
def test_count_cli_output_matches_jax(cli_files, capsys, name, engine,
                                      extra):
    argv = ["count", cli_files[name], "--engine", engine, *extra]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert torch_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert "unique sequences" in got.err and "unique sequences" in want.err
    if engine == "device" and name == "mixed" and "--top" not in extra:
        # Equal-count lines of the 64-lane bucket: JAX hash order.
        if "--json" in extra:
            assert json.loads(got.out) == json.loads(want.out)
        else:
            assert sorted(got.out.splitlines()) == \
                sorted(want.out.splitlines())
    else:
        assert got.out == want.out
    assert len(got.out) > 50


def test_count_cli_output_file_and_errors(cli_files, tmp_path, capsys):
    out = tmp_path / "counts.tsv"
    assert torch_main(["count", cli_files["narrow"], "-o", str(out),
                       "--device", "cpu"]) == 0
    assert jax_main(["count", cli_files["narrow"], "-o",
                     str(tmp_path / "want.tsv")]) == 0
    assert out.read_text() == (tmp_path / "want.tsv").read_text()
    bad = _write(tmp_path / "bad.fastq", ["ACNT"])
    capsys.readouterr()
    assert torch_main(["count", bad, "--device", "cpu"]) == 2
    assert "Unsupported base character: N" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        torch_main(["count", bad, "--shards", "0"])


@pytest.mark.parametrize("extra", [[], ["--json"], ["--top", "5"]],
                         ids=["tsv", "json", "top"])
@pytest.mark.parametrize("name", ["narrow", "mixed"])
def test_count_cli_sharded_matches_jax(cli_files, tmp_path, capsys, name,
                                       extra):
    """count --shards 3 --checkpoint DIR, byte-identical to the JAX
    package's CLI with the same flags (--top on the mixed file would cut
    a tie that the JAX package orders by hash in its 64-lane table), then
    again from the spills."""
    if name == "mixed" and "--top" in extra:
        extra = ["--top", "1"]
    flags = ["--shards", "3", *extra]
    assert jax_main(["count", cli_files[name], *flags, "--checkpoint",
                     str(tmp_path / "ck_jax")]) == 0
    want = capsys.readouterr()
    for _ in range(2):  # the second run only loads the spills
        assert torch_main(["count", cli_files[name], *flags, "--checkpoint",
                           str(tmp_path / "ck_torch"), "--device",
                           "cpu"]) == 0
        got = capsys.readouterr()
        assert got.out == want.out and len(got.out) > 10
        assert "sharded count: 3 shard(s)" in got.err
    assert sorted(p.name for p in (tmp_path / "ck_torch").iterdir()) == \
        sorted(p.name for p in (tmp_path / "ck_jax").iterdir())
    # --shards alone: no spills.
    assert torch_main(["count", cli_files[name], "--shards", "2",
                       "--device", "cpu", *extra]) == 0
    got = capsys.readouterr()
    assert jax_main(["count", cli_files[name], "--shards", "2", *extra]) == 0
    assert got.out == capsys.readouterr().out
    assert "checkpoints in" not in got.err


def test_count_cli_sharded_refuses_host_engine(cli_files, tmp_path, capsys):
    msgs = []
    for main in (torch_main, jax_main):
        assert main(["count", cli_files["narrow"], "--engine", "host",
                     "--shards", "2"]) == 2
        msgs.append(capsys.readouterr().err)
        assert main(["count", cli_files["narrow"], "--engine", "host",
                     "--checkpoint", str(tmp_path / "ck")]) == 2
        msgs.append(capsys.readouterr().err)
    assert msgs[0] == msgs[1] == msgs[2] == msgs[3]
    assert "--engine host is not available" in msgs[0]
    assert not (tmp_path / "ck").exists()


def test_pack_cli_output_matches_jax(capsys):
    seqs = ["ACGT", "", "A" * 33, "ACGT" * 30, "TTGCA" * 7]
    assert jax_main(["pack", *seqs]) == 0
    want = capsys.readouterr().out
    assert torch_main(["pack", *seqs]) == 0
    assert capsys.readouterr().out == want
    assert "ShortSeqVar" in want and "ShortSeq192" in want
