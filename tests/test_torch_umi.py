"""shortseq_torch dedup_umis / dedup_reads / the `umi` CLI against the JAX
package on identical inputs: labels and representatives (or molecules)
must be identical, on matrix, ragged and list inputs, with and without
the native hash counter, for every method and thresholds 1 and 2.
Mirrors tests/test_umi.py:322-545.  The port runs with device="cpu" here
(plain PyTorch versions of its kernels); the card's run is checked
against the CPU's at the end."""

import numpy as np
import pytest
import torch

import shortseq_torch.umi.dedup as td
import shortseq_tpu.umi.dedup as jd
from shortseq_torch.__main__ import main as torch_main
from shortseq_tpu.__main__ import main as jax_main

ALPHA = np.frombuffer(b"ACGT", np.uint8)
METHODS = ["unique", "cluster", "adjacency", "directional"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _umis(seed, lengths=(8,), n=600, pool=80):
    """UMI list with repeats and one-substitution variants; several
    lengths make it ragged."""
    rng = np.random.default_rng(seed)
    out = []
    for lng in lengths:
        base = ALPHA[rng.integers(0, 4, size=(pool, lng))]
        for _ in range(n // len(lengths)):
            u = base[rng.integers(0, pool)]
            if rng.random() < 0.3:
                u = u.copy()
                u[rng.integers(0, lng)] = ALPHA[rng.integers(0, 4)]
            out.append(u.tobytes())
    return [out[i] for i in rng.permutation(len(out))]


def _reads(seed, len_5p, len_3p, insert_lens=(12,), n=800, n_mol=60):
    """Reads from n_mol molecules with UMI errors; several insert lengths
    make the list ragged."""
    rng = np.random.default_rng(seed)
    umi_len = len_5p + len_3p
    reads = []
    for ins in insert_lens:
        mols = ALPHA[rng.integers(0, 4, size=(n_mol, umi_len + ins))]
        # Some molecules share an insert, so UMIs compete within a group.
        mols[n_mol // 2:, len_5p:len_5p + ins] = \
            mols[:n_mol - n_mol // 2, len_5p:len_5p + ins]
        for _ in range(n // len(insert_lens)):
            r = mols[rng.integers(0, n_mol)].copy()
            if rng.random() < 0.2:
                p = int(rng.integers(0, umi_len))
                j = p if p < len_5p else len(r) - (umi_len - p)
                r[j] = ALPHA[rng.integers(0, 4)]
            reads.append(r.tobytes())
    return [reads[i] for i in rng.permutation(len(reads))]


def _no_native(monkeypatch):
    """The port without its native hash counter (its numpy grouping), the
    JAX package on its Python dict path."""
    import shortseq_torch.io.native as tn

    monkeypatch.setattr(tn, "host_count_native", lambda *a, **k: None)
    monkeypatch.setattr(jd, "_unique_rows", lambda mat: None)


def _assert_same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


@pytest.mark.parametrize("path", ["matrix", "ragged", "list"])
@pytest.mark.parametrize("threshold", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_dedup_umis_matches_jax(method, threshold, path, monkeypatch):
    seed = METHODS.index(method) * 10 + threshold
    if path == "ragged":
        umis = _umis(seed, lengths=(6, 8, 11))
    else:
        umis = _umis(seed)
    if path == "list":
        _no_native(monkeypatch)
    elif path == "matrix":
        umis = np.frombuffer(b"".join(umis), np.uint8).reshape(len(umis), -1)
    got = td.dedup_umis(umis, threshold=threshold, method=method,
                        device="cpu")
    want = jd.dedup_umis(umis, threshold=threshold, method=method)
    _assert_same(got, want)


@pytest.mark.parametrize("path", ["matrix", "ragged", "list", "both_ends"])
@pytest.mark.parametrize("threshold", [1, 2])
@pytest.mark.parametrize("method", METHODS)
def test_dedup_reads_matches_jax(method, threshold, path, monkeypatch):
    seed = 100 + METHODS.index(method) * 10 + threshold
    len_5p, len_3p = (5, 3) if path == "both_ends" else (6, 0)
    inserts = (0, 7, 12) if path == "ragged" else (12,)
    reads = _reads(seed, len_5p, len_3p, insert_lens=inserts)
    if path == "list":
        _no_native(monkeypatch)
    elif path in ("matrix", "both_ends"):
        reads = np.frombuffer(b"".join(reads), np.uint8).reshape(
            len(reads), -1)
    kw = dict(len_5p=len_5p, len_3p=len_3p, threshold=threshold,
              method=method)
    _assert_same(td.dedup_reads(reads, device="cpu", **kw),
                 jd.dedup_reads(reads, **kw))


def test_blocked_matches_jax():
    reads = _reads(7, 6, 0, n=400)
    _assert_same(td.dedup_reads(reads, len_5p=6, _block=5, device="cpu"),
                 jd.dedup_reads(reads, len_5p=6, _block=5))


@pytest.mark.parametrize("fn,args,kw,match", [
    ("dedup_umis", [[b"AANA"]], {}, "Unsupported base"),
    ("dedup_reads", [["NNNN" + "ACGT"] * 3], {"len_5p": 4},
     "Unsupported base"),
    ("dedup_reads", [["ACG"]], {"len_5p": 2, "len_3p": 2}, "shorter than"),
    ("dedup_reads", [["A" * 40] * 2], {"len_5p": 33}, "longer than 32"),
    ("dedup_reads", [["ACGT"]], {}, "at least one UMI"),
    ("dedup_umis", [[b"AAAA"]], {"method": "bogus"}, "Unknown method"),
])
def test_errors_match_jax(fn, args, kw, match):
    errors = []
    for call in (lambda: getattr(td, fn)(*args, device="cpu", **kw),
                 lambda: getattr(jd, fn)(*args, **kw)):
        with pytest.raises(Exception, match=match) as info:
            call()
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_empty_inputs():
    labels, reps = td.dedup_umis([], device="cpu")
    assert len(labels) == 0 and reps == []
    labels, mols = td.dedup_reads([], len_5p=4, device="cpu")
    assert len(labels) == 0 and mols == []


def _write_fastq(path, reads):
    path.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, r, b"I" * len(r))
                              for i, r in enumerate(reads)))


@pytest.mark.parametrize("extra", [[], ["--json"], ["--top", "5"],
                                   ["--len-3p", "3", "--method", "cluster"]])
@pytest.mark.parametrize("ragged", [False, True])
def test_cli_output_is_byte_identical(tmp_path, capsys, extra, ragged):
    inserts = (9, 14) if ragged else (14,)
    path = tmp_path / "reads.fastq"
    _write_fastq(path, _reads(3, 8, 3, insert_lens=inserts, n=600))
    argv = ["umi", str(path), "--len-5p", "8", *extra]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert torch_main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    assert len(got.out) > 100       # a real table, not an empty one


def test_cli_error_exit(tmp_path, capsys):
    path = tmp_path / "reads.fastq"
    _write_fastq(path, [b"ACGTACGT"])
    assert torch_main(["umi", str(path), "--device", "cpu"]) == 2
    assert "must be positive" in capsys.readouterr().err


@pytest.mark.parametrize("gz", [False, True])
def test_read_fastq_matrix_matches_jax(tmp_path, monkeypatch, gz):
    import gzip

    import shortseq_torch.io.native as tn
    from shortseq_torch.io.fastq import read_fastq_matrix
    from shortseq_tpu.io.fastq import read_fastq_matrix as jax_read

    path = tmp_path / "reads.fastq"
    _write_fastq(path, _reads(5, 6, 2, insert_lens=(3, 17, 40), n=300))
    if gz:
        path.write_bytes(gzip.compress(path.read_bytes()))
    want = jax_read(path, pad_to=16)
    got = read_fastq_matrix(path, pad_to=16)
    monkeypatch.setattr(tn, "fastq_matrix_native", lambda *a, **k: None)
    got_numpy = read_fastq_matrix(path, pad_to=16)
    for mat, lens in (got, got_numpy):
        np.testing.assert_array_equal(mat, want[0])
        np.testing.assert_array_equal(lens, want[1])


#: name: (len_5p, len_3p, insert lengths); one insert length is a file
#: of one read length, a padded matrix of one length bucket.
FASTQ_CASES = {"3p": (0, 12, (18, 21, 25)), "both_ends": (4, 6, (9, 14)),
               "one_length": (0, 12, (20,))}


@pytest.mark.parametrize("native", [True, False], ids=["native", "no_native"])
@pytest.mark.parametrize("case", sorted(FASTQ_CASES))
def test_dedup_fastq_matches_reads_and_jax(tmp_path, capsys, monkeypatch,
                                           case, native):
    """dedup_fastq (the padded matrix from the file to the molecules)
    equals dedup_reads on the list of the same reads, and the JAX
    package's dedup_reads and CLI; without the native hash counter it
    groups in numpy and still does.  Every read of the file counts as
    taken in padded form."""
    import shortseq_torch.io.native as tn

    len_5p, len_3p, inserts = FASTQ_CASES[case]
    reads = _reads(21, len_5p, len_3p, insert_lens=inserts, n=900)
    path = tmp_path / "reads.fastq"
    _write_fastq(path, reads)
    kw = dict(len_5p=len_5p, len_3p=len_3p)
    labels, molecules = jd.dedup_reads(reads, **kw)
    if not native:
        monkeypatch.setattr(tn, "host_count_native", lambda *a, **k: None)
    padded = td._dedup_reads_ragged.padded_reads
    got, per_molecule = td.dedup_fastq(str(path), device="cpu", **kw)
    assert td._dedup_reads_ragged.padded_reads - padded == len(reads)
    assert got == molecules
    np.testing.assert_array_equal(
        per_molecule, np.bincount(labels, minlength=len(molecules)))
    _assert_same(td.dedup_reads(reads, device="cpu", **kw),
                 (labels, molecules))
    argv = ["umi", str(path), "--len-5p", str(len_5p), "--len-3p",
            str(len_3p)]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert torch_main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr() == want


@pytest.mark.parametrize("pad_to", [1, 16])
@pytest.mark.parametrize("method", METHODS)
def test_ragged_path_reads_only_each_rows_read(tmp_path, method, pad_to):
    """_dedup_reads_ragged on read_fastq_matrix's padded matrix, PAD bytes
    past every short read, gives the JAX package's labels and
    molecules."""
    from shortseq_torch.constants import PAD_BYTE
    from shortseq_torch.io.fastq import read_fastq_matrix

    reads = _reads(22, 5, 3, insert_lens=(4, 9, 11), n=600)
    path = tmp_path / "reads.fastq"
    _write_fastq(path, reads)
    mat, lengths = read_fastq_matrix(path, pad_to=pad_to)
    short = lengths < mat.shape[1]
    assert short.any() and (mat[short, -1] == PAD_BYTE).all()
    got = td._dedup_reads_ragged(mat, lengths, 5, 3, method, 1, None,
                                 torch.device("cpu"))
    _assert_same(got, jd.dedup_reads(reads, len_5p=5, len_3p=3,
                                     method=method))


def test_dedup_fastq_short_read_raises_reference_error(tmp_path, capsys):
    reads = _reads(23, 6, 2, insert_lens=(3, 10), n=200)
    reads.insert(150, b"ACGTAC")   # shorter than 6 + 2
    reads.insert(170, b"ACG")
    path = tmp_path / "reads.fastq"
    _write_fastq(path, reads)
    errors = []
    for call in (lambda: td.dedup_fastq(str(path), len_5p=6, len_3p=2,
                                        device="cpu"),
                 lambda: jd.dedup_reads(reads, len_5p=6, len_3p=2)):
        with pytest.raises(Exception, match="shorter than") as info:
            call()
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1] and "Read of 6 nt" in errors[0][1]
    argv = ["umi", str(path), "--len-5p", "6", "--len-3p", "2"]
    assert jax_main(argv) == 2
    want = capsys.readouterr()
    assert torch_main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr() == want


@pytest.mark.parametrize("width", [0, 1, 3, 4, 8, 13, 37])
def test_unique_rows_numpy_matches_native(monkeypatch, width):
    """_unique_rows without the native hash counter returns the native
    triple: the unique rows, their counts and every row's key, in first
    occurrence order, on rows of any byte (zero bytes too) and at widths
    that are and are not whole 32-bit words."""
    import shortseq_torch.io.native as tn

    assert tn.get_lib() is not None
    rng = np.random.default_rng(40 + width)
    pool = rng.integers(0, 256, size=(60, width), dtype=np.uint8)
    pool[:20] = ALPHA[rng.integers(0, 4, size=(20, width))]
    pool[20:25] = 0
    mat = pool[rng.integers(0, 60, size=900)]
    native = td._unique_rows(mat)
    monkeypatch.setattr(tn, "host_count_native", lambda *a, **k: None)
    fallback = td._unique_rows(mat)
    for got, want in zip(fallback, native):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    uniq, counts, inverse = native
    np.testing.assert_array_equal(uniq[inverse], mat)
    np.testing.assert_array_equal(counts, np.bincount(inverse))
    firsts = np.unique(inverse, return_index=True)[1]
    assert (np.diff(firsts) > 0).all()


def _random_graphs(seed, trials=20):
    """(the JAX package's per-row lists, the same graph as the port's
    CSR, counts with many ties) of random symmetric graphs of 2-119
    nodes and up to 3 * nodes edges drawn."""
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        u = int(rng.integers(2, 120))
        nbrs = [set() for _ in range(u)]
        for _ in range(int(rng.integers(0, 3 * u))):
            a, b = rng.integers(0, u, size=2)
            if a != b:
                nbrs[a].add(int(b))
                nbrs[b].add(int(a))
        nbrs = [np.asarray(sorted(x), np.int64) for x in nbrs]
        indptr = np.zeros(u + 1, np.int64)
        np.cumsum([len(x) for x in nbrs], out=indptr[1:])
        csr = td._NeighborCsr(indptr, np.concatenate(nbrs).astype(np.int64))
        yield nbrs, csr, rng.integers(1, 6, size=u).astype(np.int64)


@pytest.mark.parametrize("directional", [False, True])
def test_greedy_absorb_native_matches_python_and_jax(monkeypatch,
                                                     directional):
    import shortseq_torch.io.native as tn

    for trial, (nbrs, csr, counts) in enumerate(
            _random_graphs(5 + directional)):
        want = jd._greedy_absorb(nbrs, counts, directional)
        native = td._greedy_absorb(csr, counts, directional)
        monkeypatch.setattr(tn, "greedy_absorb_native", lambda *a: None)
        python = td._greedy_absorb(csr, counts, directional)
        monkeypatch.undo()
        np.testing.assert_array_equal(native, want, err_msg=trial)
        np.testing.assert_array_equal(python, want, err_msg=trial)


def test_components_matches_jax():
    for trial, (nbrs, csr, _) in enumerate(_random_graphs(9)):
        np.testing.assert_array_equal(td._components(csr),
                                      jd._components(nbrs), err_msg=trial)


def test_card_matches_cpu(cuda):
    reads = _reads(11, 8, 0, n=3000, n_mol=300)
    for method in METHODS:
        _assert_same(td.dedup_reads(reads, len_5p=8, method=method,
                                    device=cuda),
                     td.dedup_reads(reads, len_5p=8, method=method,
                                    device="cpu"))
    umis = _umis(12, n=3000, pool=400)
    _assert_same(td.dedup_umis(umis, threshold=2, device=cuda),
                 td.dedup_umis(umis, threshold=2, device="cpu"))
