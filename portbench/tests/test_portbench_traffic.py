"""The generator: one seed, one file; every seed the same sizes."""

import collections

import numpy as np

import traffic

SMALL = {"reads": 5000, "length_min": 15, "length_max": 32,
         "molecules": 0, "zipf_s": 0}
DUPS = {"reads": 5000, "length_min": 150, "length_max": 150,
        "molecules": 500, "zipf_s": 1.2}


def reads_of(path):
    lines = path.read_bytes().split(b"\n")
    assert lines[-1] == b"" and (len(lines) - 1) % 4 == 0
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]
    for head, seq, plus, qual in recs:
        assert head == b"@r" and plus == b"+" and qual == b"I" * len(seq)
        assert set(seq) <= set(b"ACGT")
    return [r[1] for r in recs]


def test_same_seed_same_file(tmp_path):
    for spec in (SMALL, DUPS):
        a, b, c = (tmp_path / f"{n}.fq" for n in "abc")
        assert traffic.write(spec, 2**31 + 11, a) == spec["reads"]
        traffic.write(spec, 2**31 + 11, b)
        traffic.write(spec, 2**31 + 12, c)
        assert a.read_bytes() == b.read_bytes()
        assert a.read_bytes() != c.read_bytes()


def test_every_seed_the_same_sizes(tmp_path):
    sizes = []
    for seed in (1, 2, -3, 2**33):
        path = tmp_path / f"{seed}.fq"
        traffic.write(SMALL, seed, path)
        reads = reads_of(path)
        lens = collections.Counter(map(len, reads))
        assert set(lens) == set(range(15, 33))
        assert max(lens.values()) - min(lens.values()) <= 1
        sizes.append((path.stat().st_size, sorted(lens.items())))
        path = tmp_path / f"{seed}.dup.fq"
        traffic.write(DUPS, seed, path)
        families = sorted(collections.Counter(reads_of(path)).values())
        sizes.append(families)
    assert sizes[0::2] == [sizes[0]] * 4
    assert sizes[1::2] == [sizes[1]] * 4


def test_zipf_sizes():
    s = traffic.zipf_sizes(200_000, 2_000_000, 1.2)
    assert s.sum() == 2_000_000
    assert (np.diff(s) <= 0).all()
    assert s[0] / s[1] == np.float64(s[0]) / s[1]
    assert abs(s[0] / s[1] - 2 ** 1.2) < 1e-3
