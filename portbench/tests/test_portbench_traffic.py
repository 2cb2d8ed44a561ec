"""The generator: one seed, one file; every seed the same sizes; the
libraries of the cells byte for byte as before the UMI keys; a UMI-tagged
library's inserts, UMIs and substitutions."""

import collections
import hashlib
import json
import math

import numpy as np
import pytest

import traffic
from conftest import PORTBENCH

SMALL = {"reads": 5000, "length_min": 15, "length_max": 32,
         "molecules": 0, "zipf_s": 0}
DUPS = {"reads": 5000, "length_min": 150, "length_max": 150,
        "molecules": 500, "zipf_s": 1.2}
#: 40 inserts of 18-25 nt, 1,000 molecules in Zipf families, a 12-nt UMI
#: at the 3' end: groups too small for two molecules of one insert to draw
#: the same UMI.
UMI = {"reads": 20000, "length_min": 18, "length_max": 25,
       "molecules": 1000, "zipf_s": 1.2, "inserts": 40, "insert_zipf_s": 1.0,
       "umi_3p": 12, "umi_substitution_rate": 0}
#: The same with substitutions.
UMI2 = dict(UMI, umi_substitution_rate=0.01)


def reads_of(path):
    lines = path.read_bytes().split(b"\n")
    assert lines[-1] == b"" and (len(lines) - 1) % 4 == 0
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]
    for head, seq, plus, qual in recs:
        assert head == b"@r" and plus == b"+" and qual == b"I" * len(seq)
        assert set(seq) <= set(b"ACGT")
    return [r[1] for r in recs]


def test_same_seed_same_file(tmp_path):
    for spec in (SMALL, DUPS, UMI, UMI2):
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


def smallrna_10m(reads):
    cfg = json.loads((PORTBENCH / "configs" / "smallrna_10m.json")
                     .read_text())
    return dict(cfg["library"], reads=reads)


#: sha256 of the file of each library at two seeds, as generated before
#: the UMI keys were added: their absence changes no byte.
DIGESTS = [
    (SMALL, 2147483659,
     "49f88274da868a02630ed3b73d0711aa1b56278bc488d100e2989e12a4e2683b"),
    (SMALL, 3000000001,
     "cf46d98c1600980737a416732dbfc688826838b8c2bdf4924ac4d2488e593f8f"),
    (DUPS, 2147483659,
     "0cce7a1d82dc82e6b0b77a32de7c04f17c6e93ad99445da7f9dbbd415f819c6f"),
    (DUPS, 3000000001,
     "b30dd997a1709bce6fc6c5e54ef6a5d19961d92d28f7f8b5f4cf81aaacda1b5a"),
    (smallrna_10m(200_000), 2147483659,
     "73237e4e6a9d4f451529f7a527f1d6440b63edf1b53ff7774a05aa8435c10432"),
    (smallrna_10m(200_000), 3000000001,
     "0e88edd8a08bd61f15476c7ea65870f0f5dd8c4a85dccd62729848069edc5fe0"),
]


@pytest.mark.parametrize("spec, seed, digest", DIGESTS,
                         ids=["small-a", "small-b", "dups-a", "dups-b",
                              "smallrna_10m-a", "smallrna_10m-b"])
def test_the_same_bytes_as_before_the_umi_keys(tmp_path, spec, seed,
                                               digest):
    path = tmp_path / "lib.fq"
    traffic.write(spec, seed, path)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == digest
    # The keys present at 0 are absent.
    traffic.write(dict(spec, inserts=0, insert_zipf_s=0, umi_3p=0,
                       umi_substitution_rate=0), seed, path)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == digest


def strip(read, spec):
    """The insert of a UMI-tagged read."""
    return read[:len(read) - spec["umi_3p"]]


def test_umi_library_every_seed_the_same_groups(tmp_path):
    sizes = []
    for seed in (1, -3, 2**31 + 11, 2**33):
        path = tmp_path / f"{seed}.fq"
        traffic.write(UMI2, seed, path)
        reads = reads_of(path)
        groups = collections.Counter(strip(r, UMI2) for r in reads)
        sizes.append((sorted(groups.values()),
                      sorted(collections.Counter(map(len, reads)).items())))
    assert sizes == [sizes[0]] * 4
    assert len(sizes[0][0]) == UMI2["inserts"]
    # Every insert holds its Zipf share of the molecules: with equal
    # families, 20 reads a molecule.
    path = tmp_path / "equal.fq"
    traffic.write(dict(UMI2, zipf_s=0), 5, path)
    groups = collections.Counter(strip(r, UMI2) for r in reads_of(path))
    share = traffic.zipf_sizes(UMI2["inserts"], UMI2["molecules"], 1.0)
    assert sorted(groups.values()) == sorted((20 * share).tolist())


def test_umi_library_reads_are_pool_inserts_with_umis_at_the_end(tmp_path):
    spec = dict(UMI2, umi_substitution_rate=0)
    path = tmp_path / "lib.fq"
    traffic.write(spec, 2**31 + 11, path)
    reads = reads_of(path)
    inserts = {strip(r, spec) for r in reads}
    # The UMIs' bases are random: cut at any other ends, the "inserts"
    # would far outnumber the pool.
    assert len(inserts) == spec["inserts"]
    assert {len(i) for i in inserts} <= set(range(18, 26))
    assert len({r[-12:] for r in reads}) > 0.9 * spec["molecules"]
    for lo, hi in ((0, 10), (0, 8), (3, 6)):
        assert len({r[lo:len(r) - hi] for r in reads}) > 5 * len(inserts)


def test_umi_library_exact_copies_count_as_families(tmp_path):
    path = tmp_path / "lib.fq"
    traffic.write(UMI, 2**31 + 11, path)
    got = sorted(collections.Counter(reads_of(path)).values())
    want = sorted(traffic.zipf_sizes(UMI["molecules"], UMI["reads"],
                                      UMI["zipf_s"]).tolist())
    assert got == want


def test_umi_substitutions(tmp_path):
    # At one seed, the rate changes only the UMIs' substituted bases: the
    # substitutions are drawn last, so both files hold the same molecules
    # in the same order.
    exact, noisy = tmp_path / "exact.fq", tmp_path / "noisy.fq"
    traffic.write(dict(UMI2, umi_substitution_rate=0), 7, exact)
    traffic.write(UMI2, 7, noisy)
    a, b = reads_of(exact), reads_of(noisy)
    assert [len(r) for r in a] == [len(r) for r in b]
    changed, bases = 0, 0
    for x, y in zip(a, b):
        assert strip(x, UMI2) == strip(y, UMI2)
        umi_x, umi_y = x[-12:], y[-12:]
        changed += sum(p != q for p, q in zip(umi_x, umi_y))
        bases += len(umi_x)
    e = UMI2["umi_substitution_rate"]
    assert abs(changed / bases - e) < 4 * math.sqrt(e * (1 - e) / bases)


@pytest.mark.parametrize("key", traffic.UMI_KEYS)
def test_umi_keys_need_molecules(tmp_path, key):
    spec = dict(SMALL, **{key: 0.01 if key == "umi_substitution_rate"
                          else 4})
    with pytest.raises(ValueError, match="molecules"):
        traffic.write(spec, 1, tmp_path / "lib.fq")


@pytest.mark.parametrize("key", ["inserts", "umi_3p"])
def test_a_umi_library_needs_inserts_and_a_umi(tmp_path, key):
    with pytest.raises(ValueError, match="inserts and umi_3p"):
        traffic.write(dict(UMI, **{key: 0}), 1, tmp_path / "lib.fq")


#: sha256 of UMI2's file at two seeds: a later cell's library stays as
#: it was sized.
UMI2_DIGESTS = [
    (2147483659,
     "b4da6319fd529ae5126c017a0360c4b53cbc1ed9246fd92be62e9617a10b43a6"),
    (3000000001,
     "80c56c826d77f86116ed40da3d31a2f26b2d129ea1f2c58c3e70f75e03a74ed3"),
]


@pytest.mark.parametrize("seed, digest", UMI2_DIGESTS, ids=["a", "b"])
def test_umi_library_bytes(tmp_path, seed, digest):
    path = tmp_path / "lib.fq"
    traffic.write(UMI2, seed, path)
    assert hashlib.sha256(path.read_bytes()).hexdigest() == digest


def test_insert_pool_redraws_repeats():
    rng = traffic.rng_for(5)
    # All 16 sequences of 2 nt: a plain draw of 16 repeats some.
    pools, lengths, rows = traffic.distinct_pool(rng, 16, 2, 2)
    assert len({bytes(r) for r in pools[2]}) == 16
    assert sorted(rows.tolist()) == list(range(16))
    with pytest.raises(ValueError):
        traffic.distinct_pool(rng, 17, 2, 2)
