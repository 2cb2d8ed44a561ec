#!/usr/bin/env python3
"""Drive shortseq_torch's UMI slice once on one CUDA card and check it.

Usage (from the repository root, one card):  python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  device     a CUDA card is present; its name and power limit (nvidia-smi)
  build      kernels A, B, C (nvcc, sm_90a) and the host library (g++)
             from this checkout's sources, with the seconds each took
  kernels    each kernel against its plain PyTorch version on the card at
             the slice's shapes (integers: exact equality), with median
             CUDA-event times over 7 runs, L2 flushed before each run
  umi_scale  dedup_umis on 100,000 unique 12-nt UMIs x 3 (directional,
             threshold 1): a valid partition, a 512-row slab of neighbour
             lists against the plain pairwise check, and a 5,000-unique
             problem identical to device="cpu"
  umi_cli    1,000,000 reads (100,000 molecules, 8-nt UMI, 20-nt insert,
             2% UMI errors) through `python -m shortseq_torch umi` as a
             subprocess, and through dedup_reads in this process: molecule
             count within 5% of the truth, <= 1% split molecules, counts
             summing to the reads, and the CLI's table equal to the API's
  counters   kernels A, B and C all launched while phases umi_scale and
             umi_cli drove the main path (counts reset just before), the
             native host library loaded and the matrix paths taken

Before the last line it prints a JSON object of per-kernel results; the
last line is {"ok": true, "device": {"platform": "gpu", ...}}.  Random
data comes from numpy seeds, so every run checks the same inputs.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCE = "shortseq_torch/csrc/kernels.cu"


def phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        detail = fn(*args)
    except BaseException:
        print(f"phase {name}: FAILED after {time.perf_counter() - t0:.3f} s",
              flush=True)
        raise
    print(f"phase {name}: ok ({time.perf_counter() - t0:.3f} s) {detail}",
          flush=True)


# --- data -------------------------------------------------------------------


def rand_umis(u, length, seed=0):
    """benchmarks/umi_scale.py's generator: u random ACGT strings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGT", np.uint8)
    mat = alphabet[rng.integers(0, 4, size=(u, length))]
    return [mat[i].tobytes() for i in range(u)]


def make_reads(n, n_mol, umi_len=8, insert_len=20, err=0.02, seed=0):
    """benchmarks/umi_reads_scale.py's generator: n reads drawn from n_mol
    molecules, with one random base of the UMI replaced at rate err."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    mols = alpha[rng.integers(0, 4, size=(n_mol, umi_len + insert_len))]
    which = rng.integers(0, n_mol, size=n)
    mat = mols[which].copy()
    hit = rng.random(n) < err
    pos = rng.integers(0, umi_len, size=n)
    mat[hit, pos[hit]] = alpha[rng.integers(0, 4, size=n)[hit]]
    return mat, which


def write_fastq(path, mat):
    """One 4-line record per row: '@r', the row, '+', all-'I' quality."""
    import numpy as np

    n, length = mat.shape
    rec = np.empty((n, 3 + length + 3 + length + 1), np.uint8)
    rec[:, 0:3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + length] = mat
    rec[:, 3 + length:6 + length] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, 6 + length:6 + 2 * length] = ord("I")
    rec[:, -1] = ord("\n")
    Path(path).write_bytes(rec.tobytes())


# --- timing -----------------------------------------------------------------


class Timer:
    """Median CUDA-event time of a callable, with L2 flushed before each
    run by zeroing a buffer larger than the card's L2."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fns, runs=7):
        torch = self.torch
        for fn in fns:
            fn()
        times = [[] for _ in fns]
        for _ in range(runs):
            # In turns, so drift hits every version alike.
            for t, fn in zip(times, fns):
                self.flush.zero_()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                t.append(start.elapsed_time(end))
        return [statistics.median(t) for t in times]


# --- phases -----------------------------------------------------------------


def phase_device(torch, out):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    out["smi"] = smi[0]
    out["kind"] = torch.cuda.get_device_name(0)
    out["count"] = torch.cuda.device_count()
    return f"{out['kind']} x{out['count']}, nvidia-smi: {smi[0]}"


def phase_build():
    from shortseq_torch import _build

    t0 = time.perf_counter()
    cuda = _build.build_cuda()
    t1 = time.perf_counter()
    host = _build.build_host()
    t2 = time.perf_counter()
    if host is None:
        raise RuntimeError("host library (csrc/fastq_index.cpp) did not build")
    _build.cuda_lib()
    return (f"kernels {t1 - t0:.3f} s ({cuda.name}), "
            f"host {t2 - t1:.3f} s ({host.name})")


def phase_kernels(torch, results):
    import numpy as np

    from shortseq_torch.ops import bitpack, hamming, pairwise
    from shortseq_torch.ops.lanes import from_numpy_u32
    from shortseq_torch.umi import dedup

    timer = Timer(torch)
    rng = np.random.default_rng(0)
    lines = []

    def exact(name, got, want):
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                bad = (g != w).sum().item() if g.shape == w.shape else "shape"
                raise AssertionError(f"{name}: kernel != plain ({bad})")
        return max((g.long() - w.long()).abs().max().item()
                   for g, w in zip(got, want) if g.numel())

    # A: pack + validate.  1% of bytes invalid, random lengths.
    alpha = np.frombuffer(b"ACGT", np.uint8)
    errs, a_main = [], None
    for n, w4 in ((102144, 8), (8192, 24), (4096, 256)):
        mat = alpha[rng.integers(0, 4, size=(n, 4 * w4))]
        bad = rng.random(mat.shape) < 0.01
        mat[bad] = rng.integers(0, 256, size=int(bad.sum()))
        lens = rng.integers(0, 4 * w4 + 1, size=n).astype(np.int32)
        x = from_numpy_u32(mat.view(np.uint32)).cuda()
        ln = torch.from_numpy(lens).cuda()
        for pad_valid in (False, True):
            errs.append(exact(
                f"A [{n},{w4}] pad_valid={pad_valid}",
                bitpack.pack_and_validate_u32(x, ln, pad_valid),
                bitpack.pack_and_validate_plain(x, ln, pad_valid)))
            ms, plain_ms = timer([
                lambda: bitpack.pack_and_validate_u32(x, ln, pad_valid),
                lambda: bitpack.pack_and_validate_plain(x, ln, pad_valid)])
            lines.append(f"A [{n},{w4}] pad_valid={pad_valid}: "
                         f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
            if a_main is None:
                a_main = (ms, plain_ms)
    results["pack_validate"] = dict(
        replaces="shortseq_tpu/ops/bitpack.py:330",
        max_abs_err=max(errs), ms=a_main[0], plain_ms=a_main[1])

    # B: all-pairs hamming.  The slice's shape first: a 2688-row block of
    # 12-nt UMIs against all 102144 padded rows.  Two random groups and
    # threshold 3 give rows ~20 neighbours, so C's k=16 cap truncates.
    u_pad, block, lo = 102144, 2688, 2688 * 7
    umis = np.frombuffer(b"".join(rand_umis(u_pad, 12, seed=2)),
                         np.uint8).reshape(u_pad, 12)
    mat = np.zeros((u_pad, 32), np.uint8)
    mat[:, :12] = umis
    lens = np.full(u_pad, 12, np.int32)
    words, ok = bitpack.pack_and_validate_rows(mat.view(np.uint32), lens,
                                               "cuda")
    assert bool(ok.all())
    lens_d = torch.from_numpy(lens).cuda()
    lens_d[-500:] = -1                       # pad rows, as the slice pads
    gids_d = torch.from_numpy(
        rng.integers(0, 2, size=u_pad).astype(np.int32)).cuda()
    rows_d = torch.arange(u_pad, dtype=torch.int32, device="cuda")
    a = words[lo:lo + block]
    slab = torch.empty((block, u_pad), dtype=torch.int32, device="cuda")
    errs = [exact("B [2688]x[102144] W=2",
                  [pairwise.hamming_pairwise_tiled(a, words, out=slab)],
                  [hamming.hamming_pairwise(a, words)])]
    b_main = timer([lambda: pairwise.hamming_pairwise_tiled(a, words,
                                                            out=slab),
                    lambda: hamming.hamming_pairwise(a, words)])
    lines.append(f"B [2688]x[102144] W=2: {b_main[0]:.4f} ms, "
                 f"plain {b_main[1]:.4f} ms")
    for w in (6, 64):
        aw = torch.from_numpy(rng.integers(-2**31, 2**31, size=(512, w),
                                           dtype=np.int64)
                              .astype(np.int32)).cuda()
        bw = torch.from_numpy(rng.integers(-2**31, 2**31, size=(16384, w),
                                           dtype=np.int64)
                              .astype(np.int32)).cuda()
        errs.append(exact(f"B [512]x[16384] W={w}",
                          [pairwise.hamming_pairwise_tiled(aw, bw)],
                          [hamming.hamming_pairwise(aw, bw)]))
        ms, plain_ms = timer([lambda: pairwise.hamming_pairwise_tiled(aw, bw),
                              lambda: hamming.hamming_pairwise(aw, bw)])
        lines.append(f"B [512]x[16384] W={w}: {ms:.4f} ms, "
                     f"plain {plain_ms:.4f} ms")
    results["pairwise_hamming"] = dict(
        replaces="shortseq_tpu/ops/pallas_kernels.py:75",
        max_abs_err=max(errs), ms=b_main[0], plain_ms=b_main[1])

    # C: neighbour extraction on B's slab.
    pairwise.hamming_pairwise_tiled(a, words, out=slab)
    sl = slice(lo, lo + block)
    args = (slab, lens_d[sl], gids_d[sl], rows_d[sl], lens_d, gids_d, 3)
    errs, c_main = [], None
    for k in (16, 128):
        got = dedup.neighbor_extract(*args, k)
        want = dedup.neighbor_extract_plain(*args, k)
        errs.append(exact(f"C k={k}", got, want))
        over = int((want[1] > k).sum())
        ms, plain_ms = timer([lambda: dedup.neighbor_extract(*args, k),
                              lambda: dedup.neighbor_extract_plain(*args, k)])
        lines.append(f"C [2688,102144] k={k} ({over} rows over k): "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
        if c_main is None:
            c_main = (ms, plain_ms)
    results["neighbor_extract"] = dict(
        replaces="shortseq_tpu/umi/dedup.py:180",
        max_abs_err=max(errs), ms=c_main[0], plain_ms=c_main[1])
    for line in lines:
        print("  " + line, flush=True)
    return "all kernels equal their plain versions"


class MainPath:
    """Launch counts of kernels A, B and C over the main path's runs
    only: each run starts every count at 0 and adds what it launched."""

    def __init__(self):
        from shortseq_torch.ops import bitpack, pairwise
        from shortseq_torch.umi import dedup

        self.wrappers = {"pack_validate": bitpack.pack_and_validate_u32,
                         "pairwise_hamming": pairwise.hamming_pairwise_tiled,
                         "neighbor_extract": dedup.neighbor_extract}
        self.launches = dict.fromkeys(self.wrappers, 0)

    def run(self, fn, *args, **kwargs):
        for w in self.wrappers.values():
            w.launches = 0
        out = fn(*args, **kwargs)
        for name, w in self.wrappers.items():
            self.launches[name] += w.launches
        return out


def phase_umi_scale(torch, main_path):
    import numpy as np

    from shortseq_torch.ops.hamming import hamming_pairwise
    from shortseq_torch.umi import dedup

    uniq = rand_umis(100_000, 12, seed=0)
    umis = uniq * 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, reps = main_path.run(dedup.dedup_umis, umis, threshold=1,
                                 method="directional", device="cuda")
    wall = time.perf_counter() - t0

    # A valid partition: every UMI labelled, every cluster used, and each
    # representative is one of its cluster's UMIs.
    n = len(umis)
    assert labels.shape == (n,) and labels.min() >= 0, labels.shape
    assert np.array_equal(np.unique(labels), np.arange(len(reps)))
    umi_mat = np.frombuffer(b"".join(umis), np.uint8).reshape(n, 12)
    rep_mat = np.frombuffer(b"".join(reps), np.uint8).reshape(len(reps), 12)
    has_rep = np.unique(labels[(umi_mat == rep_mat[labels]).all(axis=1)])
    assert len(has_rep) == len(reps), (len(has_rep), len(reps))

    # A 512-row slab of the blocked neighbour lists against the plain
    # dense check.
    words, lengths = dedup._pack_validate_umis(uniq, "cuda")
    nbrs = dedup._neighbor_lists(words, lengths, 1, device="cuda")
    lo = int(np.random.default_rng(7).integers(0, len(uniq) - 512))
    dense = (hamming_pairwise(words[lo:lo + 512], words) <= 1).cpu().numpy()
    for r in range(512):
        want = np.setdiff1d(np.flatnonzero(dense[r]), [lo + r])
        assert np.array_equal(np.asarray(nbrs[lo + r]), want), lo + r
    edges = sum(len(x) for x in nbrs)

    # A 5,000-unique problem with real clusters (half the UMIs are one
    # substitution from another), identical on the card and on the CPU.
    rng = np.random.default_rng(1)
    base = np.frombuffer(b"".join(rand_umis(2500, 12, seed=3)),
                         np.uint8).reshape(2500, 12)
    var = base.copy()
    pos = rng.integers(0, 12, size=2500)
    var[np.arange(2500), pos] = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=2500)]
    small = [r.tobytes() for r in np.concatenate([base, base, base, var])]
    got = dedup.dedup_umis(small, threshold=1, device="cuda")
    want = dedup.dedup_umis(small, threshold=1, device="cpu")
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    return (f"wall {wall:.3f} s for {n} UMIs ({len(uniq)} unique) -> "
            f"{len(reps)} clusters; slab rows {lo}..{lo + 511} exact "
            f"({edges} edges in all); 5k problem: {len(got[1])} clusters, "
            f"equal to cpu")


def phase_umi_cli(torch, main_path, workdir):
    import numpy as np

    from shortseq_torch.io.fastq import read_fastq_matrix
    from shortseq_torch.umi import dedup

    n, n_mol = 1_000_000, 100_000
    mat, which = make_reads(n, n_mol)
    path = Path(workdir) / "umi_reads.fastq"
    write_fastq(path, mat)

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "shortseq_torch", "umi", str(path),
         "--len-5p", "8"], cwd=ROOT, capture_output=True, timeout=900)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"CLI exit {proc.returncode}: "
                           f"{proc.stderr.decode(errors='replace')}")
    rows = proc.stdout.decode().splitlines()
    counts = [int(r.rsplit("\t", 1)[1]) for r in rows]
    assert sum(counts) == n, sum(counts)
    assert n_mol * 0.95 <= len(rows) <= n_mol * 1.05, len(rows)

    # The same reads through the API in this process: labels for the
    # split gate, and the table the CLI must have printed.
    reads_mat, lengths = read_fastq_matrix(path, pad_to=1)
    reads = np.ascontiguousarray(reads_mat[:, :lengths[0]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, molecules = main_path.run(dedup.dedup_reads, reads, len_5p=8,
                                      device="cuda")
    api_wall = time.perf_counter() - t0
    per_mol = np.bincount(labels, minlength=len(molecules))
    items = sorted(zip(molecules, per_mol), key=lambda kv: -kv[1])
    table = [f"{i.decode()}\t{u.decode()}\t{c}" for (i, u), c in items]
    assert table == rows, "CLI table differs from the API's"

    # Split gate of benchmarks/umi_reads_scale.py on the first 200k reads.
    sample = 200_000
    pairs = np.unique(np.stack([which[:sample], labels[:sample]]), axis=1)
    mols, n_labels = np.unique(pairs[0], return_counts=True)
    split = int((n_labels > 1).sum())
    assert split <= len(mols) * 0.01, (split, len(mols))
    return (f"CLI wall {cli_wall:.3f} s, API wall {api_wall:.3f} s for {n} "
            f"reads -> {len(rows)} molecules (truth {n_mol}); "
            f"{split}/{len(mols)} sampled molecules split")


# --- main -------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "shortseq_torch" / "csrc").is_dir():
        print(f"chip_smoke: no shortseq_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from shortseq_torch.io import native
    from shortseq_torch.umi import dedup

    dev, results = {}, {}
    phase("device", phase_device, torch, dev)
    phase("build", phase_build)
    phase("kernels", phase_kernels, torch, results)

    # The main path: kernel launches and grouping paths counted.
    main_path = MainPath()
    paths = {}
    for name in ("_dedup_umi_matrix", "_dedup_reads_matrix"):
        real = getattr(dedup, name)

        def counted(*a, _real=real, _name=name, **k):
            paths[_name] = paths.get(_name, 0) + 1
            return _real(*a, **k)

        setattr(dedup, name, counted)
    with tempfile.TemporaryDirectory() as workdir:
        phase("umi_scale", phase_umi_scale, torch, main_path)
        phase("umi_cli", phase_umi_cli, torch, main_path, workdir)
    launches = main_path.launches

    def counters():
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
        if native.get_lib() is None:
            raise AssertionError("native host library not loaded")
        if set(paths) != {"_dedup_umi_matrix", "_dedup_reads_matrix"}:
            raise AssertionError(f"matrix paths not all taken: {paths}")
        return f"launches {launches}, matrix paths {paths}"

    phase("counters", counters)
    kernels = [dict(name=name, route="cuda", source=SOURCE,
                    replaces=r["replaces"], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"]) for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
