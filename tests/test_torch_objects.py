"""The port's ShortSeq objects, native (csrc/shortseq_native.cpp built as
shortseq_torch._native) and pure Python (shortseq_torch/api/seq.py),
against the JAX package's same two backends: values, types, hashes,
sizes, reprs, slices, hamming and error classes and messages.  A
parametrised subset of tests/test_differential.py.

The two packages' native types are separate types, so objects are never
compared across packages: only their strings, hashes and outcomes."""

import os
import random
import subprocess
import sys
from pathlib import Path

import pytest

import shortseq_torch.api.seq as tpy
import shortseq_tpu.api.seq as jpy
from shortseq_torch import _build
from shortseq_tpu.native_build import load as _jax_native

ROOT = Path(__file__).resolve().parent.parent
BACKENDS = ("native", "python")


@pytest.fixture(params=BACKENDS)
def pair(request):
    """(port backend, JAX backend) of the same kind."""
    if request.param == "python":
        return tpy, jpy
    t, j = _build.load_objects(), _jax_native()
    if t is None or j is None:
        pytest.skip("native extension unavailable (no g++ or headers)")
    return t, j


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:
        return ("err", type(e).__name__, str(e))


def _rand_seq(rng, length):
    return "".join(rng.choice("ACTG") for _ in range(length))


def test_construct_decode_hash_sizeof(pair):
    t, j = pair
    rng = random.Random(42)
    for _ in range(200):
        s = _rand_seq(rng, rng.randint(0, 1024))
        a, b = t.pack(s), j.pack(s)
        assert str(a) == str(b) == s
        assert hash(a) == hash(b)
        assert len(a) == len(b)
        assert sys.getsizeof(a) == sys.getsizeof(b)
        assert type(a).__name__ == type(b).__name__
        assert repr(a) == repr(b)
        assert str(t.from_bytes(s.encode())) == s == str(t.from_str(s))


def test_slices_agree(pair):
    t, j = pair
    rng = random.Random(43)
    for _ in range(150):
        s = _rand_seq(rng, rng.randint(1, 300))
        a, b = t.pack(s), j.pack(s)
        start = rng.randint(-len(s) - 2, len(s) + 2)
        stop = rng.randint(-len(s) - 2, len(s) + 2)
        assert _outcome(lambda: str(a[start:stop])) == \
            _outcome(lambda: str(b[start:stop])) == ("ok", s[start:stop])
        idx = rng.randint(-len(s) - 2, len(s) + 2)
        assert _outcome(lambda: str(a[idx])) == _outcome(lambda: str(b[idx]))


def test_hamming_agree(pair):
    t, _ = pair
    rng = random.Random(44)
    for _ in range(150):
        n = rng.randint(1, 200)
        s1, s2 = _rand_seq(rng, n), _rand_seq(rng, n)
        assert t.pack(s1) ^ t.pack(s2) == sum(x != y for x, y in zip(s1, s2))


@pytest.mark.parametrize("case", [
    lambda m: m.pack("ACGNT"),
    lambda m: m.pack("acgt"),
    lambda m: m.pack("ACGU"),
    lambda m: m.pack("A" * 1025),
    lambda m: m.pack(12345),
    lambda m: m.pack("ACGTACGT")[::2],
    lambda m: m.pack("ACGT")[1.5],
    lambda m: m.pack("ACGT")[9],
    lambda m: m.pack("ACG") ^ m.pack("ACGT"),
    lambda m: m.pack("ACG") ^ 5,
    lambda m: m.from_blocks((1,), 40),
], ids=["N", "lower", "U", "too_long", "int", "step", "float_index",
        "index", "xor_len", "xor_type", "few_blocks"])
def test_errors_agree(pair, case):
    t, j = pair
    got, want = _outcome(lambda: case(t)), _outcome(lambda: case(j))
    assert got[0] == "err"
    assert got == want


def test_from_blocks_agree(pair):
    t, j = pair
    rng = random.Random(47)
    for _ in range(100):
        length = rng.randint(0, 1024)
        blocks = tuple(rng.getrandbits(64) for _ in range(-(-length // 32)
                                                          or 1))
        a, b = t.from_blocks(blocks, length), j.from_blocks(blocks, length)
        assert str(a) == str(b) and hash(a) == hash(b)
        assert a == t.pack(str(a))


def test_eq_matrix(pair):
    t, _ = pair
    rng = random.Random(45)
    seqs = [_rand_seq(rng, rng.randint(0, 120)) for _ in range(10)]
    for s1 in seqs:
        for s2 in seqs:
            assert (t.pack(s1) == t.pack(s2)) == (s1 == s2)
            assert (t.pack(s1) == s2) == (s1 == s2)
            assert (t.pack(s1) == s2.encode()) is False


def test_package_backend_and_counter():
    import shortseq_torch as st

    assert st.BACKEND == ("native" if _build.load_objects() else "python")
    c = st.ShortSeqCounter([b"ATGC"] * 10 + [b"A" * 40])
    assert c == {st.pack("ATGC"): 10, st.pack("A" * 40): 1}
    with pytest.raises(TypeError, match="does not support"):
        c["ACGT"] = 1
    assert (st.MIN_VAR_NT, st.MAX_VAR_NT) == (97, 1024)


def test_force_python_env():
    code = ("import shortseq_torch as st, shortseq_torch._build as b\n"
            "from shortseq_torch.io import native\n"
            "assert st.BACKEND == 'python', st.BACKEND\n"
            "assert b._objects is None and native.get_lib() is None\n"
            "assert type(st.pack('ACGT')).__module__ == "
            "'shortseq_torch.api.seq'\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT),
               SHORTSEQ_TORCH_FORCE_PYTHON="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
