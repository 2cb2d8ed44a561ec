#!/usr/bin/env python3
"""Drive shortseq_torch's slices once on one CUDA card and check them.

Usage (from the repository root, one card):  python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  device     a CUDA card is present; its name and power limit (nvidia-smi)
  build      kernels A to H and K10 (nvcc, sm_90a, one process per source),
             the host library and the object extension (g++) from this
             checkout's sources, all started together, with the seconds
             each took, and the object backend
  kernels    each kernel against its plain PyTorch version on the card at
             the slices' shapes (integers: exact equality), with median
             CUDA-event times over 7 runs (3 for the largest), L2 flushed
             before each run, each beside its bound (bytes at 3.35 TB/s or
             popcounts at 4.18e12/s, whichever is longer), and the card's
             SM clock and power draw sampled throughout; B at
             [2688] x [102144] W = 2, [4096] x [131072] W = 10 and
             [512] x [16384] W = 6 and 64, each also against the one-hot
             product; C on B's band slab at k = 16 and 128; H on the band
             at k = 16 and 128 (also against B + C) and at the main path's
             [100000] x [102144] (also against B + C over 38 bands); for
             B, C and H also each launch's device time (torch.profiler),
             which leaves out the wrapper's host time that the CUDA
             events include;
             for D also its edge cases (tile edges from
             GROUP_TILE_ROWS, poison, int32 wraps, small n_out, PAD
             rows, N = 1, W = 1 and 5), a one-key shape, each of its
             launches' device times (torch.profiler), the sort and the
             whole unique_count; kernel A's pack-only mode at [2M, 40]
             (150-nt rows), E at [2M, 10], F static (8, 100) and ragged
             at [2M, 10], G at [2M, 10] and [262144, 64], and the one-hot
             pairwise product against B at [512] x [16384], W = 1, 2, 10,
             64
  umi_scale  dedup_umis on 100,000 unique 12-nt UMIs x 3 (directional,
             threshold 1): a valid partition, the neighbour lists' wall
             and the host's split of them timed alone, a 512-row slab of
             neighbour lists against the plain pairwise check, a
             5,000-unique problem identical to device="cpu", and 8,200
             UMIs (7,400 unique) in error fans at threshold 2 (rows over
             the main pass's cap, so the overflow tier runs B + C)
             identical to device="cpu"
  umi_cli    1,000,000 reads (100,000 molecules, 8-nt UMI, 20-nt insert,
             2% UMI errors) through `python -m shortseq_torch umi` as a
             subprocess, and through dedup_reads in this process: molecule
             count within 5% of the truth, <= 1% split molecules, counts
             summing to the reads, and the CLI's table equal to the API's
  count      three FASTQ files (10,000,000 reads of 15-32 nt; 2,000,000
             reads of 150 nt drawn Zipf(1.2) from 200,000 molecules;
             1,000,000 reads of 0-300 nt from a 300,000-read pool) through
             read_and_count_fastq_table with engine="device" on the card
             and engine="host": equal live tables, total() = reads, equal
             most_common(20) above its 20th count; for the third file
             also to_counter() and count_matrix_device (kernel A); the
             first file again in 256 MiB slices (streamed), equal to the
             whole-file table; `python -m shortseq_torch count --engine
             device --top 20` on the second file as a subprocess, equal
             to the in-process top 20
  batch      2,000,000 reads of 150 nt (Zipf(1.2) from 200,000 molecules)
             as a FASTQ -> read_fastq_matrix -> PackedBatch.from_matrix on
             the card: decode() equal to the reads (kernel E, the copy to
             the host and the host's strings timed apart), trim(8, 100) and
             trim_ragged against Python slices on 10,000 rows, hamming
             against a copy with known substitutions, a 4096-row block
             against 131,072 rows through the calibrated pairwise selector
             (the choice, never plain, and its times per lane width),
             counts() equal to the host engine's table; pack_batch on
             200,000 strings equal to from_matrix, and its invalid-base
             error; to_objects() on 100,000 rows equal to pack(str);
             umi_adjacency on 8,192 12-nt UMIs against the plain pairwise
  sharded    count's files 1 and 2 through the sharded and distributed
             path: `python -m shortseq_torch count FILE1 --shards 8
             --checkpoint DIR --top 20` as a subprocess, equal to phase
             count's top 20; 3 of the 8 spills deleted, then
             count_fastq_sharded recounts exactly those 3 and equals the
             whole-file table; under a one-rank NCCL group (file:// init)
             make_sharded_counter on file 1's ASCII rows (tier 1,
             scattered), read_and_count_fastq_distributed(n_shards=4),
             count_sharded_auto at capacity factor 0.25 on file 2's
             64-lane words (tier 2) and file 1's 2-lane words (tier 3),
             each equal to phase count's table, and DistributedCountTable's
             len, total, most_common(20), get and values equal to
             CountTable's; K10 against its plain version (edge cases, then
             file 1's [10M,2] words at D = 1, 2, 3, 6, 8, 65536 and file
             2's [2M,64] at D = 8, timed with CUDA events and
             torch.profiler); the lazy reads (K8) on file 1's table timed
  counters   kernels A to H and K10 all launched while phases umi_scale,
             umi_cli, count, batch and sharded drove the main path (counts
             reset just before each run), H in umi_scale and umi_cli, B +
             C in umi_scale's overflow tier, D during count, A in
             count_matrix_device, A's pack-only mode, E, F and G in batch,
             K10 in sharded, and the pairwise choice in batch; all three
             merge tiers taken; the native host library loaded, the UMI
             matrix paths, the count path's device engine, 4-chunk
             transfer and streamed slices, count_fastq_sharded and
             read_and_count_fastq_distributed all taken

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
SOURCE_D = "shortseq_torch/csrc/count.cu"
SOURCE_BATCH = "shortseq_torch/csrc/batch.cu"
SOURCE_UMI = "shortseq_torch/csrc/umi.cu"
SOURCE_DIST = "shortseq_torch/csrc/dist.cu"

# The least time a kernel could take (bound_ms): the larger of its bytes
# (each input read once, each output written once) at the H100 SXM's HBM
# rate and its popcounts at __popc's rate (16 per SM per clock, 132 SMs at
# 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
POPC_PER_S = 132 * 16 * 1.98e9


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


def fan_umis(n_base, length, seed, reps=5):
    """Error fans: n_base random UMIs, each `reps` times, then every one of
    its 3 * length single-substitution variants once.  At threshold 2 a
    fan's rows are each other's neighbours (~3 * length of them)."""
    import numpy as np

    alpha = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for b in np.frombuffer(b"".join(rand_umis(n_base, length, seed)),
                           np.uint8).reshape(n_base, length):
        out.extend([b.tobytes()] * reps)
        for pos in range(length):
            for c in alpha:
                if c != b[pos]:
                    v = b.copy()
                    v[pos] = c
                    out.append(v.tobytes())
    return out


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


def write_fastq_ragged(path, seqs, lengths, chunk=1 << 20):
    """write_fastq's records for reads of any length: read i is
    seqs[offsets[i]:offsets[i] + lengths[i]] of one flat uint8 array.
    Vectorized over chunks of rows."""
    import numpy as np

    lengths = np.asarray(lengths, np.int64)
    offsets = np.cumsum(lengths) - lengths
    with open(path, "wb") as f:
        for lo in range(0, len(lengths), chunk):
            ln = lengths[lo:lo + chunk]
            rec = 2 * ln + 7
            start = np.cumsum(rec) - rec
            out = np.full(int(rec.sum()), ord("I"), np.uint8)
            out[start] = ord("@")
            out[start + 1] = ord("r")
            out[start + 2] = ord("\n")
            out[start + 3 + ln] = ord("\n")
            out[start + 4 + ln] = ord("+")
            out[start + 5 + ln] = ord("\n")
            out[start + 6 + 2 * ln] = ord("\n")
            col = np.arange(int(ln.sum())) - np.repeat(np.cumsum(ln) - ln, ln)
            src = np.repeat(offsets[lo:lo + chunk], ln) + col
            out[np.repeat(start + 3, ln) + col] = seqs[src]
            f.write(out.tobytes())


def zipf_pick(rng, n_keys, size, s=1.2):
    """size draws from n_keys keys with P(k) proportional to k^-s."""
    import numpy as np

    p = 1.0 / np.arange(1, n_keys + 1, dtype=np.float64) ** s
    return rng.choice(n_keys, size=size, p=p / p.sum())


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


def exact(name, got, want):
    """Raise unless each kernel output equals its plain version's; the
    max abs error (0)."""
    import torch

    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            bad = (g != w).sum().item() if g.shape == w.shape else "shape"
            raise AssertionError(f"{name}: kernel != plain ({bad})")
    return max((g.long() - w.long()).abs().max().item()
               for g, w in zip(got, want) if g.numel())


def bound(inputs, outputs, popc=0):
    """(bound_ms, bound_by) of one call: its bytes at HBM_BYTES_PER_S
    against its popcounts at POPC_PER_S, whichever takes longer."""
    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = popc / POPC_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_text(b):
    return f"bound {b[0]:.4f} ms ({b[1]})"


class SmiSampler:
    """The card's SM clock and power draw, sampled by nvidia-smi every
    100 ms in the background while the `with` block runs."""

    def __enter__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        for line in out.splitlines():
            try:
                mhz, watts = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((mhz, watts))
        return False

    def summary(self):
        if not self.samples:
            return "clocks.sm and power.draw: not sampled"
        mhz, watts = zip(*self.samples)
        return (f"clocks.sm {min(mhz):.0f}-{max(mhz):.0f} MHz (median "
                f"{statistics.median(mhz):.0f}), power.draw {min(watts):.1f}-"
                f"{max(watts):.1f} W (median {statistics.median(watts):.1f}) "
                f"over {len(mhz)} samples")


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
    from concurrent.futures import ThreadPoolExecutor

    import shortseq_torch
    from shortseq_torch import _build

    def timed(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    # All compilers start together: nvcc per .cu inside build_cuda, g++
    # for the host library and the object extension beside it.
    with ThreadPoolExecutor(3) as pool:
        jobs = [pool.submit(timed, fn) for fn in
                (_build.build_cuda, _build.build_host, _build.build_objects)]
        (cuda, t_cuda), (host, t_host), (objects, t_obj) = \
            [j.result() for j in jobs]
    if host is None:
        raise RuntimeError("host library (csrc/fastq_index.cpp) did not build")
    if objects is None:
        raise RuntimeError(
            "object extension (csrc/shortseq_native.cpp) did not build")
    _build.cuda_lib()
    if shortseq_torch.BACKEND != "native":
        raise RuntimeError(f"object backend is {shortseq_torch.BACKEND}")
    return (f"kernels {t_cuda:.3f} s ({cuda.name}), host {t_host:.3f} s "
            f"({host.name}), objects {t_obj:.3f} s ({objects.name}); "
            f"BACKEND {shortseq_torch.BACKEND}")


def phase_kernels(torch, results):
    """Every kernel against its plain version, timed, with the card's SM
    clock and power draw sampled throughout."""
    lines = []
    with SmiSampler() as smi:
        kernel_checks(torch, results, lines)
    for line in lines:
        print("  " + line, flush=True)
    print("  during the kernel timings: " + smi.summary(), flush=True)
    return "all kernels equal their plain versions"


def kernel_checks(torch, results, lines):
    import numpy as np

    from shortseq_torch.ops import bitpack, hamming, pairwise
    from shortseq_torch.ops.lanes import from_numpy_u32
    from shortseq_torch.umi import dedup

    timer = Timer(torch)
    rng = np.random.default_rng(0)

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
            want = bitpack.pack_and_validate_plain(x, ln, pad_valid)
            errs.append(exact(
                f"A [{n},{w4}] pad_valid={pad_valid}",
                bitpack.pack_and_validate_u32(x, ln, pad_valid), want))
            ms, plain_ms = timer([
                lambda: bitpack.pack_and_validate_u32(x, ln, pad_valid),
                lambda: bitpack.pack_and_validate_plain(x, ln, pad_valid)])
            bnd = bound([x, ln], want)
            lines.append(f"A [{n},{w4}] pad_valid={pad_valid}: "
                         f"{ms:.4f} ms, plain {plain_ms:.4f} ms; "
                         + bound_text(bnd))
            if a_main is None:
                a_main = (ms, plain_ms, bnd)
    results["pack_validate"] = dict(
        replaces="shortseq_tpu/ops/bitpack.py:330",
        max_abs_err=max(errs), ms=a_main[0], plain_ms=a_main[1],
        bound_ms=a_main[2][0], bound_by=a_main[2][1], library_ms=None)

    # B: all-pairs hamming at its callers' shapes, each against plain and
    # against the one-hot float16 product, its yardstick (library_ms):
    # a 2688-row band of 12-nt UMIs against all 102144 padded rows (W = 2;
    # the UMI main pass before kernel H, and H's band below);
    # PackedBatch.pairwise's 4096-row block against 131072 rows of 150 nt
    # (W = 10; plain in 256-row chunks, whose broadcast would need 21 GB);
    # the calibration shape [512] x [16384] at W = 6 and 64.
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
    # Two random groups and threshold 3 give rows ~20 neighbours, so the
    # k = 16 cap truncates.
    gids_d = torch.from_numpy(
        rng.integers(0, 2, size=u_pad).astype(np.int32)).cuda()
    rows_d = torch.arange(u_pad, dtype=torch.int32, device="cuda")
    a = words[lo:lo + block]
    slab = torch.empty((block, u_pad), dtype=torch.int32, device="cuda")

    def rand_lanes(n, w):
        return torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, w),
                                             dtype=np.int64)
                                .astype(np.int32)).cuda()

    def b_case(name, a, b, out=None, chunk=None, runs=7):
        def kernel():
            return pairwise.hamming_pairwise_tiled(a, b, out=out)

        def plain():
            if chunk is None:
                return hamming.hamming_pairwise(a, b)
            return torch.cat([hamming.hamming_pairwise(a[i:i + chunk], b)
                              for i in range(0, len(a), chunk)])

        got = kernel()
        err = exact(f"B {name}", [got], [plain()])
        t = timer([kernel, plain,
                   lambda: hamming.hamming_pairwise_onehot(a, b)], runs)
        n, w = a.shape
        bnd = bound([a, b], [got], popc=n * len(b) * -(-w // 2))
        split = launch_split(torch, kernel, ("pairwise",))
        lines.append(f"B {name}: {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
                     f"one-hot {t[2]:.4f} ms; {bound_text(bnd)}; {split}")
        return err, t, bnd

    errs = [b_case("[2688]x[102144] W=2", a, words, out=slab)[0]]
    for w in (6, 64):
        errs.append(b_case(f"[512]x[16384] W={w}", rand_lanes(512, w),
                           rand_lanes(16384, w))[0])
    aw, bw = rand_lanes(4096, 10), rand_lanes(131072, 10)
    err, t, bnd = b_case("[4096]x[131072] W=10", aw, bw, chunk=256, runs=3)
    del aw, bw
    torch.cuda.empty_cache()
    results["pairwise_hamming"] = dict(
        replaces="shortseq_tpu/ops/pallas_kernels.py:75",
        max_abs_err=max(errs + [err]), ms=t[0], plain_ms=t[1],
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=t[2])

    # C: neighbour extraction on B's slab of the band.
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
        bnd = bound(args[:6], want)
        split = launch_split(torch, lambda: dedup.neighbor_extract(*args, k),
                             ("neighbor_extract",))
        lines.append(f"C [2688,102144] k={k} ({over} rows over k): "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms; "
                     f"{bound_text(bnd)}; {split}")
        if c_main is None:
            c_main = (ms, plain_ms, bnd)
    results["neighbor_extract"] = dict(
        replaces="shortseq_tpu/umi/dedup.py:180",
        max_abs_err=max(errs), ms=c_main[0], plain_ms=c_main[1],
        bound_ms=c_main[2][0], bound_by=c_main[2][1], library_ms=None)

    # H: fused neighbour lists.  The band at k = 16 and 128, against its
    # plain version and against B + C on the same band; then the main
    # path's shape (dedup_umis on 100000 unique 12-nt UMIs: every real row
    # against all 102144 columns, threshold 1, k = 16) against plain and
    # against B + C over the 38 bands, the main pass that H replaced.
    def b_then_c(rows, threshold, k):
        parts = []
        for s in range(0, rows, block):
            e = min(s + block, rows)
            pairwise.hamming_pairwise_tiled(words[s:e], words,
                                            out=slab[:e - s])
            parts.append(dedup.neighbor_extract(
                slab[:e - s], lens_d[s:e], gids_d[s:e], rows_d[s:e],
                lens_d, gids_d, threshold, k))
        return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in
                                                            parts])

    errs = []
    for k in (16, 128):
        hargs = (a, lens_d[sl], gids_d[sl], rows_d[sl], words, lens_d,
                 gids_d, 3, k)
        want = dedup.neighbor_lists_fused_plain(*hargs)
        errs.append(exact(f"H band k={k}",
                          dedup.neighbor_lists_fused(*hargs), want))
        t = timer([lambda: dedup.neighbor_lists_fused(*hargs),
                   lambda: dedup.neighbor_lists_fused_plain(*hargs),
                   lambda: dedup.neighbor_extract(
                       pairwise.hamming_pairwise_tiled(a, words, out=slab),
                       *args[1:], k)])
        bnd = bound(hargs[:7], want, popc=block * u_pad)
        split = launch_split(torch,
                             lambda: dedup.neighbor_lists_fused(*hargs),
                             ("neighbor_lists", "neighbor_merge"))
        lines.append(f"H band [2688]x[102144] k={k}: {t[0]:.4f} ms, plain "
                     f"{t[1]:.4f} ms, B + C {t[2]:.4f} ms; "
                     f"{bound_text(bnd)}; {split}")
    real = 100_000
    hall = (words[:real], lens_d[:real], gids_d[:real], rows_d[:real],
            words, lens_d, gids_d, 1, 16)
    got = dedup.neighbor_lists_fused(*hall)
    errs.append(exact("H [100000]x[102144]", got,
                      dedup.neighbor_lists_fused_plain(*hall)))
    exact("H [100000]x[102144] against B + C", got,
          [x[:real] for x in b_then_c(u_pad, 1, 16)])
    t = timer([lambda: dedup.neighbor_lists_fused(*hall),
               lambda: dedup.neighbor_lists_fused_plain(*hall),
               lambda: b_then_c(u_pad, 1, 16)], runs=3)
    split = launch_split(torch, lambda: dedup.neighbor_lists_fused(*hall),
                         ("neighbor_lists", "neighbor_merge"))
    bnd = bound(hall[:7], got, popc=real * u_pad)
    lines.append(f"H [100000]x[102144] k=16 (the main path's shape): "
                 f"{t[0]:.4f} ms, plain {t[1]:.4f} ms, B + C over 38 bands "
                 f"{t[2]:.4f} ms; {bound_text(bnd)}; {split}")
    results["neighbor_lists_fused"] = dict(
        source=SOURCE_UMI, replaces="shortseq_tpu/umi/dedup.py:180",
        max_abs_err=max(errs), ms=t[0], plain_ms=t[1], bound_ms=bnd[0],
        bound_by=bnd[1], library_ms=None)
    del slab

    results["unique_count"] = kernel_d(torch, timer, rng, lines)
    results.update(batch_kernels(torch, timer, rng, lines))


def d_edge_cases(tile):
    """Kernel D's exactness cases, built from its tile's row count:
    (name, words uint32 [N, W], lengths, weights, n_out).  Groups keep
    the order of `sizes` after the sort (lane 0 numbers them), so their
    edges fall where the sizes put them."""
    import numpy as np

    pad = 2**31 - 1
    rng = np.random.default_rng(11)

    def groups(sizes, w, live=True):
        keys = rng.integers(0, 2**32, size=(len(sizes), w),
                            dtype=np.uint64).astype(np.uint32)
        keys[:, 0] = np.arange(len(sizes))
        rows = rng.permutation(np.repeat(np.arange(len(sizes)), sizes))
        return keys[rows], np.full(len(rows), 16 if live else pad, np.int32)

    def ones(words):
        return np.ones(len(words), np.int32)

    cases = []
    # Groups of tile-1, tile and tile+1 rows (the first ends on a tile's
    # second-last row, the third on a tile's last), then one that starts
    # mid-tile and covers the next tiles whole; W = 1 and 5 are rows that
    # are not 16-byte aligned.
    edges = [tile - 1, tile, tile + 1, tile // 2, 2 * tile + tile // 2 + 3, 7]
    for w in (1, 2, 5, 6, 64):
        words, lens = groups(edges, w)
        cases.append((f"tile edges W={w}", words, lens,
                      rng.integers(1, 5, size=len(lens)).astype(np.int32),
                      None))
    lens = np.repeat(np.array([4, 5, 6, 7], np.int32),
                     [tile - 1, tile + 1, tile, 3])
    cases.append(("length-only edges", np.zeros((len(lens), 2), np.uint32),
                  lens, ones(lens), None))
    words = np.array([[1, 0], [1, 0], [2, 0], [3, 0]], np.uint32)
    cases.append(("poison, a group cancelling to 0", words,
                  np.full(4, 16, np.int32),
                  np.array([5, -5, 2, 2], np.int32), None))
    words, lens = groups([tile + 1, 3, tile], 2)
    wts = ones(words)
    wts[len(wts) // 2] = -1
    cases.append(("poison across tiles", words, lens, wts, None))
    for name, wts in (("int32 wrap, 3 x 1.9e9", [1_900_000_000] * 3),
                      ("int32 wrap negative, 2 x 2e9", [2_000_000_000] * 2),
                      ("negative sum, 2 x -2e9", [-2_000_000_000] * 2)):
        cases.append((name, np.full((len(wts), 2), 0x78, np.uint32),
                      np.full(len(wts), 4, np.int32),
                      np.array(wts, np.int32), None))
    words, lens = groups([tile + 5], 2)
    cases.append(("int32 wrap across a tile edge", words, lens,
                  np.full(len(lens), 1_100_000, np.int32), None))
    words, lens = groups([3] * 1500 + [tile + 2], 2)
    for n_out in (1, 1000):
        cases.append((f"n_out {n_out} below 1501 groups", words, lens,
                      ones(words), n_out))
    words, lens = groups([tile, 4, tile + 3], 2, live=False)
    cases.append(("all PAD, stale words in 3 dead groups", words, lens,
                  rng.integers(-3, 5, size=len(lens)).astype(np.int32), None))
    words, lens = groups([tile - 3, 1, 7, tile], 6)
    lens[rng.random(len(lens)) < 0.4] = pad
    cases.append(("live rows then PAD rows with stale words", words, lens,
                  np.where(lens == pad, -7, 2).astype(np.int32), None))
    for name, length in (("N = 1", 4), ("N = 1, PAD", pad)):
        cases.append((name, np.array([[5, 6]], np.uint32),
                      np.array([length], np.int32), np.array([3], np.int32),
                      None))
    return cases


def launch_split(torch, fn, tags, runs=3):
    """Device ms a launch of fn's launches whose kernel names hold each
    tag (for D: tile, finish, and the fills of its scratch; for H: the
    lists and the merge), from torch.profiler over `runs` calls, beside
    the launches it saw of each tag.  Every tag's time is divided by the
    launches seen, never by `runs`, so a profile that drops a call's
    events cannot shrink it, and the count shows that it did.  The
    profile idles 50 ms on each side of the calls: late in a long
    process the profiler has dropped the launches of a call's first
    millisecond or so, as if the card's clock had drifted from the
    host's.  L2 is flushed before each call by an add over 128 MiB,
    which no tag matches."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(runs):
            flush.add_(1)
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    split, seen = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        for tag in tags:
            if tag in e.key.lower():
                split[tag] = split.get(tag, 0.0) + us / 1000
                seen[tag] = seen.get(tag, 0) + e.count
    if not split.get(tags[0]):
        return "launch split not measured (the profiler saw no device time)"
    return f"device ms a launch (launches seen in {runs} calls): " + \
        ", ".join(f"{k} {v / seen[k]:.4f} ms x {seen[k]}"
                  for k, v in split.items())


def kernel_d(torch, timer, rng, lines):
    """Kernel D against its plain version: the edge cases of d_edge_cases
    (exact, not timed), then the timed shapes: random 32-nt-class rows
    (nearly all unique), 150-nt rows drawn Zipf(1.2) from 200,000 keys
    (one group of ~390,000 rows), 96-nt-class rows from a pool, and
    32-nt-class rows that are all one key (the worst skew)."""
    import numpy as np

    from shortseq_torch.count import device as cdev
    from shortseq_torch.ops.lanes import from_numpy_u32

    errs = []
    cases = d_edge_cases(cdev.GROUP_TILE_ROWS)
    for name, words, lens, wts, n_out in cases:
        words = from_numpy_u32(words).cuda()
        lens, wts = torch.from_numpy(lens).cuda(), torch.from_numpy(wts).cuda()
        n_out = len(lens) if n_out is None else n_out
        perm = cdev.sort_rows(words, lens)
        errs.append(exact(f"D {name}",
                          cdev.group_count(words, lens, wts, perm, n_out),
                          cdev.group_count_plain(words, lens, wts, perm,
                                                 n_out)))
    torch.cuda.synchronize()
    lines.append(f"D: {len(cases)} edge cases exact (tile "
                 f"{cdev.GROUP_TILE_ROWS} rows)")
    d_main = None
    for n, w, keys, zipf, lens in (
            (10_000_000, 2, None, False, (15, 32)),
            (2_000_000, 64, 200_000, True, (150, 150)),
            (1_000_000, 6, 300_000, False, (33, 96)),
            (10_000_000, 2, 1, False, (24, 24))):
        m = keys or n
        pool = torch.from_numpy(rng.integers(-2**31, 2**31, size=(m, w),
                                             dtype=np.int64)
                                .astype(np.int32)).cuda()
        pool_len = torch.from_numpy(rng.integers(
            lens[0], lens[1] + 1, size=m).astype(np.int32)).cuda()
        if keys is None:
            words, lengths = pool, pool_len
        else:
            pick = zipf_pick(rng, keys, n) if zipf else \
                rng.integers(0, keys, size=n)
            pick = torch.from_numpy(pick).cuda()
            words, lengths = pool[pick].contiguous(), pool_len[pick]
            del pool, pool_len
        weights = torch.ones(n, dtype=torch.int32, device="cuda")
        perm = cdev.sort_rows(words, lengths)
        want = cdev.group_count_plain(words, lengths, weights, perm, n)
        errs.append(exact(
            f"D [{n},{w}]",
            cdev.group_count(words, lengths, weights, perm, n), want))
        biggest, groups = int(want[2].max()), int(want[3])
        bnd = bound([words, lengths, weights, perm], want)
        del want
        ms, plain_ms, sort_ms, total_ms = timer([
            lambda: cdev.group_count(words, lengths, weights, perm, n),
            lambda: cdev.group_count_plain(words, lengths, weights, perm, n),
            lambda: cdev.sort_rows(words, lengths),
            lambda: cdev.unique_count(words, lengths, weights)])
        split = launch_split(
            torch, lambda: cdev.group_count(words, lengths, weights, perm, n),
            ("group_tile", "group_finish", "fill"))
        lines.append(f"D [{n},{w}] ({groups} groups, largest {biggest}): "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {split}; "
                     f"sort {sort_ms:.4f} ms; unique_count {total_ms:.4f} "
                     f"ms; {bound_text(bnd)}")
        if d_main is None:
            d_main = (ms, plain_ms, bnd)
        del words, lengths, weights, perm
    return dict(source=SOURCE_D, replaces="shortseq_tpu/count/device.py:156",
                max_abs_err=max(errs), ms=d_main[0], plain_ms=d_main[1],
                bound_ms=d_main[2][0], bound_by=d_main[2][1], library_ms=None)


def batch_kernels(torch, timer, rng, lines):
    """Kernel A's pack-only mode, E, F and G against their plain versions
    at the batch phase's shapes (2M rows of 150 nt: 40 byte lanes, 10
    packed lanes), G also at 64 lanes, and the one-hot pairwise product
    against kernel B at the calibration shape."""
    import numpy as np

    from shortseq_torch import batch
    from shortseq_torch.ops import bitpack, hamming, pairwise
    from shortseq_torch.ops.lanes import from_numpy_u32

    out = {}
    n = 2_000_000
    alpha = np.frombuffer(b"ACGT", np.uint8)
    mat = np.full((n, 160), 1, np.uint8)            # PAD_BYTE past 150
    mat[:, :150] = alpha[rng.integers(0, 4, size=(n, 150), dtype=np.uint8)]
    x = from_numpy_u32(mat.view(np.uint32)).cuda()
    del mat

    def entry(name, source, replaces, errs, times, bnd):
        out[name] = dict(source=source, replaces=replaces,
                         max_abs_err=max(errs), ms=times[0],
                         plain_ms=times[1], bound_ms=bnd[0],
                         bound_by=bnd[1], library_ms=None)

    words = bitpack.pack_words_plain(x)
    err = exact("A pack-only [2M,40]", [bitpack.pack_words_u32(x)], [words])
    t = timer([lambda: bitpack.pack_words_u32(x),
               lambda: bitpack.pack_words_plain(x)])
    bnd = bound([x], [words])
    lines.append(f"A pack-only [2M,40]: {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
                 + bound_text(bnd))
    entry("pack_words", SOURCE, "shortseq_tpu/ops/bitpack.py:116", [err], t,
          bnd)

    del x
    want = bitpack.unpack_ascii_plain(words)
    err = exact("E [2M,10]", [bitpack.unpack_ascii(words)], [want])
    t = timer([lambda: bitpack.unpack_ascii(words),
               lambda: bitpack.unpack_ascii_plain(words)])
    bnd = bound([words], [want])
    del want
    lines.append(f"E [2M,10]: {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
                 + bound_text(bnd))
    entry("unpack_ascii", SOURCE_BATCH, "shortseq_tpu/ops/bitpack.py:148",
          [err], t, bnd)

    lens = torch.full((n,), 150, dtype=torch.int32, device="cuda")
    starts = torch.from_numpy(
        rng.integers(0, 41, size=n).astype(np.int32)).cuda()
    keep = torch.from_numpy(
        rng.integers(60, 151, size=n).astype(np.int32)).cuda()
    static = (words, lens, 8, 100, 7)
    ragged = (words, lens, starts, keep, 10)
    want = batch.trim_words_plain(*static)
    bnd = bound(static[:2], want)
    errs = [exact("F static (8, 100) [2M,10]", batch.trim_words(*static),
                  want),
            exact("F ragged [2M,10]", batch.trim_words_ragged(*ragged),
                  batch.trim_words_ragged_plain(*ragged))]
    t_static = timer([lambda: batch.trim_words(*static),
                      lambda: batch.trim_words_plain(*static)])
    t_ragged = timer([lambda: batch.trim_words_ragged(*ragged),
                      lambda: batch.trim_words_ragged_plain(*ragged)])
    lines.append(f"F static (8, 100) [2M,10]: {t_static[0]:.4f} ms, plain "
                 f"{t_static[1]:.4f} ms; ragged (starts 0-40, lengths "
                 f"60-150): {t_ragged[0]:.4f} ms, plain {t_ragged[1]:.4f} ms;"
                 f" static {bound_text(bnd)}")
    entry("trim_words", SOURCE_BATCH, "shortseq_tpu/batch.py:56", errs,
          t_static, bnd)

    errs, g_main = [], None
    other = words.roll(1, 0)
    wide = [torch.from_numpy(rng.integers(-2**31, 2**31, size=(262144, 64),
                                          dtype=np.int64)
                             .astype(np.int32)).cuda() for _ in range(2)]
    for name, a, b in (("[2M,10]", words, other),
                       ("[262144,64]", wide[0], wide[1])):
        want = hamming.hamming_rows_plain(a, b)
        errs.append(exact(f"G {name}", [hamming.hamming_rows(a, b)], [want]))
        t = timer([lambda: hamming.hamming_rows(a, b),
                   lambda: hamming.hamming_rows_plain(a, b)])
        bnd = bound([a, b], [want], popc=a.shape[0] * -(-a.shape[1] // 2))
        lines.append(f"G {name}: {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
                     + bound_text(bnd))
        g_main = g_main or (t, bnd)
    entry("hamming_rows", SOURCE_BATCH, "shortseq_tpu/ops/hamming.py:26",
          errs, *g_main)
    del words, other, wide, lens, starts, keep

    for w in (1, 2, 10, 64):
        a = torch.from_numpy(rng.integers(-2**31, 2**31, size=(512, w),
                                          dtype=np.int64)
                             .astype(np.int32)).cuda()
        b = torch.from_numpy(rng.integers(-2**31, 2**31, size=(16384, w),
                                          dtype=np.int64)
                             .astype(np.int32)).cuda()
        b[:512] = a ^ (1 << 2 * (w % 16))         # near-identical rows
        exact(f"onehot W={w}", [hamming.hamming_pairwise_onehot(a, b)],
              [pairwise.hamming_pairwise_tiled(a, b)])
        t = timer([lambda: hamming.hamming_pairwise_onehot(a, b),
                   lambda: pairwise.hamming_pairwise_tiled(a, b)])
        lines.append(f"onehot [512]x[16384] W={w}: {t[0]:.4f} ms, kernel B "
                     f"{t[1]:.4f} ms (equal)")
    return out


def one_bucket_keys(seed, n, d, w=2, length=20):
    """n distinct uint32 [n, w] keys whose rows of `length` nt all hash to
    bucket 0 of d (the port's plain hash on the host)."""
    import numpy as np
    import torch

    from shortseq_torch.dist.count import _bucket_hash
    from shortseq_torch.ops.lanes import from_numpy_u32

    rng = np.random.default_rng(seed)
    keys = set()
    while len(keys) < n:
        cand = rng.integers(0, 2**32, size=(8192, w), dtype=np.uint64) \
            .astype(np.uint32)
        b = _bucket_hash(from_numpy_u32(cand),
                         torch.full((8192,), length, dtype=torch.int32),
                         d).numpy()
        keys.update(map(tuple, cand[b == 0]))
    return np.asarray(sorted(keys)[:n], np.uint32)


def k10_edge_cases(tile):
    """K10's exactness cases from its tile's row count: (name, words
    uint32 [N, W], lengths, D, cap or None for capacity factor 2).  Every
    third row is PAD unless the case says otherwise."""
    import numpy as np

    def rows(seed, n, w):
        rng = np.random.default_rng(seed)
        words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64) \
            .astype(np.uint32)
        lengths = rng.integers(0, 16 * w + 1, size=n).astype(np.int32)
        lengths[::3] = 2**31 - 1
        return words, lengths

    cases = [(f"D={d} N={n} W={w}", *rows(n + d, n, w), d, None)
             for d, n, w in ((1, tile - 1, 2), (2, tile, 2), (3, tile + 1, 2),
                             (6, 3 * tile + 5, 5), (8, 4 * tile, 64),
                             (3, 37, 1), (65536, 2 * tile + 7, 2))]
    keys = one_bucket_keys(0, 3 * tile, 6)
    lengths = np.full(len(keys), 20, np.int32)
    cases += [("D=6 all rows in bucket 0, cap = rows", keys, lengths, 6,
               len(keys)),
              ("D=6 all rows in bucket 0, cap = rows - 1", keys, lengths, 6,
               len(keys) - 1)]
    cases.append(("N = 0", np.zeros((0, 2), np.uint32),
                  np.zeros(0, np.int32), 4, 0))
    return cases


def kernel_k10(torch, timer, lines, shapes, main):
    """K10 (bucket ids + send buffers) against its plain version: the edge
    cases of k10_edge_cases and a tile grown past BUCKET_TILE_ROWS (exact,
    not timed), then each (name, words, lengths, weights, [(D, capacity
    factor)]) of `shapes`, exact and timed (CUDA events and
    torch.profiler).  `main` is the (name, D, factor) whose times go in
    the JSON line; no single PyTorch call computes this function
    (library_ms null)."""
    from shortseq_torch.dist import count as dc
    from shortseq_torch.ops.lanes import from_numpy_u32

    def check(name, words, lengths, weights, d, cap):
        got = dc.bucket_send_buffers(words, lengths, weights, d, cap)
        want = dc.bucket_send_buffers_plain(words, lengths, weights, d, cap)
        return exact(f"K10 {name}", got, want), want

    errs = []
    cases = k10_edge_cases(dc.BUCKET_TILE_ROWS)
    for name, words, lengths, d, cap in cases:
        n = len(lengths)
        w = from_numpy_u32(words).cuda()
        ln = torch.from_numpy(lengths).cuda()
        wt = torch.arange(n, dtype=torch.int32, device="cuda") % 7 + 1
        cap = dc.bucket_capacity(n, d, 2.0) if cap is None else cap
        err, want = check(name, w, ln, wt, d, cap)
        errs.append(err)
        if "cap = rows - 1" in name and not int(want[3]):
            raise AssertionError("K10: the capacity edge did not overflow")
    saved = dc._HISTOGRAM_INTS
    dc._HISTOGRAM_INTS = 64   # D x 4 tiles > 64: tiles of 2048 and 4096 rows
    try:
        w = from_numpy_u32(cases[3][1]).cuda()
        ln = torch.from_numpy(cases[3][2]).cuda()
        wt = torch.ones(len(ln), dtype=torch.int32, device="cuda")
        for d in (17, 40):
            errs.append(check(f"grown tile D={d}", w, ln, wt, d,
                              dc.bucket_capacity(len(ln), d, 2.0))[0])
    finally:
        dc._HISTOGRAM_INTS = saved
    # 4-lane rows 4 bytes past a 16-byte boundary: the scatter's copies
    # fall back from 16-byte to 4-byte pieces.
    gen = torch.Generator(device="cuda").manual_seed(5)
    flat = torch.randint(-2**31, 2**31 - 1, (4 * 3001 + 1,),
                         dtype=torch.int32, device="cuda", generator=gen)
    ln = torch.randint(0, 65, (3001,), dtype=torch.int32, device="cuda",
                       generator=gen)
    ln[::4] = 2**31 - 1
    wt = torch.ones(3001, dtype=torch.int32, device="cuda")
    errs.append(check("W=4 at a 4-byte offset", flat[1:].view(3001, 4), ln,
                      wt, 3, dc.bucket_capacity(3001, 3, 2.0))[0])
    lines.append(f"K10: {len(cases) + 3} edge cases exact (tile "
                 f"{dc.BUCKET_TILE_ROWS} rows; one bucket at the capacity "
                 "edge; N = 0; a grown tile; rows off 16-byte alignment)")
    got_main = None
    for name, words, lengths, weights, runs in shapes:
        n = words.shape[0]
        for d, factor in runs:
            cap = dc.bucket_capacity(n, d, factor)
            err, want = check(f"{name} D={d} factor {factor}", words,
                              lengths, weights, d, cap)
            errs.append(err)
            bnd = bound([words, lengths, weights], want)
            loads = int(want[1].ne(2**31 - 1).sum())
            over = int(want[3])
            del want
            ms, plain_ms = timer([
                lambda: dc.bucket_send_buffers(words, lengths, weights, d,
                                               cap),
                lambda: dc.bucket_send_buffers_plain(words, lengths, weights,
                                                     d, cap)])
            split = launch_split(
                torch, lambda: dc.bucket_send_buffers(words, lengths,
                                                      weights, d, cap),
                ("bucket_hash", "bucket_scan", "bucket_scatter"))
            lines.append(f"K10 {name} D={d} factor {factor} (cap {cap}, "
                         f"{loads} rows placed, overflow {over}): "
                         f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {split}; "
                         f"{bound_text(bnd)}")
            if (name, d, factor) == main:
                got_main = (ms, plain_ms, bnd)
    if got_main is None:
        raise AssertionError(f"K10: no timed case is {main}")
    return dict(source=SOURCE_DIST, replaces="shortseq_tpu/dist/count.py:75",
                max_abs_err=max(errs), ms=got_main[0], plain_ms=got_main[1],
                bound_ms=got_main[2][0], bound_by=got_main[2][1],
                library_ms=None)


class MainPath:
    """Launch counts of kernels A to H and K10 over the main path's runs
    only: each run starts every count at 0 and adds what it launched, in
    all (`launches`), per phase (`by_phase`) and for the last run
    (`last`)."""

    def __init__(self):
        from shortseq_torch import batch
        from shortseq_torch.count import device as cdev
        from shortseq_torch.dist import count as dc
        from shortseq_torch.ops import bitpack, hamming, pairwise
        from shortseq_torch.umi import dedup

        self.wrappers = {"pack_validate": bitpack.pack_and_validate_u32,
                         "pairwise_hamming": pairwise.hamming_pairwise_tiled,
                         "neighbor_extract": dedup.neighbor_extract,
                         "neighbor_lists_fused": dedup.neighbor_lists_fused,
                         "unique_count": cdev.group_count,
                         "pack_words": bitpack.pack_words_u32,
                         "unpack_ascii": bitpack.unpack_ascii,
                         "trim_words": batch.trim_words_ragged,
                         "hamming_rows": hamming.hamming_rows,
                         "bucket_send": dc.bucket_send_buffers}
        self.launches = dict.fromkeys(self.wrappers, 0)
        self.by_phase = {}
        self.last = {}

    def run(self, phase_name, fn, *args, **kwargs):
        for w in self.wrappers.values():
            w.launches = 0
        out = fn(*args, **kwargs)
        self.last = {name: w.launches for name, w in self.wrappers.items()}
        per = self.by_phase.setdefault(phase_name,
                                       dict.fromkeys(self.wrappers, 0))
        for name, n in self.last.items():
            self.launches[name] += n
            per[name] += n
        return out


def phase_umi_scale(torch, main_path):
    import numpy as np

    from shortseq_torch.ops.hamming import hamming_pairwise
    from shortseq_torch.umi import dedup

    uniq = rand_umis(100_000, 12, seed=0)
    umis = uniq * 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels, reps = main_path.run("umi_scale", dedup.dedup_umis, umis,
                                 threshold=1, method="directional",
                                 device="cuda")
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

    # A 512-row slab of the neighbour lists against the plain dense check;
    # the lists' wall, and the host's split of the fetched lists into one
    # array per row timed alone on the same lists.
    words, lengths = dedup._pack_validate_umis(uniq, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbrs = dedup._neighbor_lists(words, lengths, 1, device="cuda")
    lists_s = time.perf_counter() - t0
    flat = np.concatenate(nbrs)
    ends = np.cumsum([len(x) for x in nbrs])[:-1]
    split_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        np.split(flat, ends)
        split_times.append(time.perf_counter() - t0)
    split_s = statistics.median(split_times)
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

    # Error fans at threshold 2: every row has more neighbours than the
    # main pass keeps (16), so the overflow tier runs kernels B + C on the
    # main path, after kernel H.
    fans = fan_umis(200, 12, seed=5)
    over = main_path.run("umi_scale", dedup.dedup_umis, fans, threshold=2,
                         device="cuda")
    ran = main_path.last
    if not (ran["neighbor_lists_fused"] and ran["pairwise_hamming"]
            and ran["neighbor_extract"]):
        raise AssertionError(f"the overflow tier did not run: {ran}")
    want = dedup.dedup_umis(fans, threshold=2, device="cpu")
    assert np.array_equal(over[0], want[0]) and over[1] == want[1]
    return (f"wall {wall:.3f} s for {n} UMIs ({len(uniq)} unique) -> "
            f"{len(reps)} clusters; _neighbor_lists {lists_s:.3f} s; "
            f"np.split into {len(nbrs)} lists alone {split_s:.3f} s "
            f"(median of 3); slab "
            f"rows {lo}..{lo + 511} exact ({edges} edges in all); 5k "
            f"problem: {len(got[1])} clusters, equal to cpu; {len(fans)} "
            f"fan UMIs at threshold 2: {len(over[1])} clusters, equal to "
            f"cpu, launches H {ran['neighbor_lists_fused']}, B "
            f"{ran['pairwise_hamming']}, C {ran['neighbor_extract']}")


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
    labels, molecules = main_path.run("umi_cli", dedup.dedup_reads, reads,
                                      len_5p=8, device="cuda")
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


def live_rows(table):
    """A CountTable's live rows per bucket width: {W: (words uint32,
    lengths int32, counts int64)}."""
    import numpy as np

    from shortseq_torch.count.device import fetch_table

    out = {}
    for b in table._buckets:
        if b.device:
            w, lens, cnts, _ = fetch_table(b.words, b.lengths, b.counts,
                                           b._n)
        else:
            n = b.n_unique
            w, lens, cnts = b.words[:n], b.lengths[:n], b.counts[:n]
        out[b.width] = (np.asarray(w, np.uint32), np.asarray(lens, np.int32),
                        np.asarray(cnts, np.int64))
    return out


def assert_same_rows(got, want, what):
    """Equal live tables, bucket by bucket, as row-sorted arrays (rows
    ordered by length, then the lanes as unsigned)."""
    import numpy as np

    def ordered(w, lens, cnts):
        order = np.lexsort([w[:, j] for j in range(w.shape[1] - 1, -1, -1)]
                           + [lens])
        return w[order], lens[order], cnts[order]

    if set(got) != set(want):
        raise AssertionError(f"{what}: buckets {sorted(got)} vs "
                             f"{sorted(want)}")
    for width in got:
        a, b = ordered(*got[width]), ordered(*want[width])
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{what}: {width}-lane tables differ")


def count_files(workdir):
    """The count phase's three FASTQ files, from fixed seeds."""
    import numpy as np

    alpha = np.frombuffer(b"ACGT", np.uint8)
    files = {}
    # 1: 10M uniform reads of 15-32 nt (benchmarks/profile_10m.py's shape).
    rng = np.random.default_rng(0)
    lens = rng.integers(15, 33, size=10_000_000)
    files["10m_15-32nt"] = (Path(workdir) / "reads_10m.fastq", len(lens))
    write_fastq_ragged(files["10m_15-32nt"][0],
                       alpha[rng.integers(0, 4, size=int(lens.sum()))], lens)
    # 2: 2M reads of 150 nt, PCR duplicates drawn Zipf(1.2) from 200k.
    rng = np.random.default_rng(1)
    mols = alpha[rng.integers(0, 4, size=(200_000, 150))]
    files["2m_150nt_zipf"] = (Path(workdir) / "reads_150nt.fastq", 2_000_000)
    write_fastq(files["2m_150nt_zipf"][0],
                mols[zipf_pick(rng, 200_000, 2_000_000)])
    del mols
    # 3: 1M reads of 0-300 nt (all three buckets, empty reads) drawn from
    # a pool of 300k reads.
    rng = np.random.default_rng(2)
    pool_len = rng.integers(0, 301, size=300_000)
    pool = alpha[rng.integers(0, 4, size=int(pool_len.sum()))]
    pick = rng.integers(0, 300_000, size=1_000_000)
    lens = pool_len[pick]
    col = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    seqs = pool[np.repeat((np.cumsum(pool_len) - pool_len)[pick], lens) + col]
    files["1m_0-300nt"] = (Path(workdir) / "reads_mixed.fastq", len(lens))
    write_fastq_ragged(files["1m_0-300nt"][0], seqs, lens)
    return files


def phase_count(torch, main_path, workdir, found):
    import contextlib
    import io
    import os

    import numpy as np

    import shortseq_torch as st
    from shortseq_torch.api.counter import count_matrix_device
    from shortseq_torch.io.fastq import read_fastq_matrix

    t0 = time.perf_counter()
    files = count_files(workdir)
    gen_s = time.perf_counter() - t0
    lines = []

    def count(path, engine):
        log = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            if engine == "device":
                table = main_path.run("count", st.read_and_count_fastq_table,
                                      path, engine="device", device="cuda")
            else:
                table = st.read_and_count_fastq_table(path, engine="host")
        wall = time.perf_counter() - t0
        return table, (f"{engine} {wall:.3f} s (read "
                       f"{table._read_seconds:.3f} s, count "
                       f"{wall - table._read_seconds:.3f} s)")

    tables = {}
    for name, (path, n_reads) in files.items():
        dev, dev_wall = count(path, "device")
        host, host_wall = count(path, "host")
        dev_rows = live_rows(dev)
        assert_same_rows(dev_rows, live_rows(host), f"{name} device vs host")
        if not dev.total() == host.total() == n_reads:
            raise AssertionError(f"{name}: totals {dev.total()}, "
                                 f"{host.total()}, reads {n_reads}")
        top_d = [(str(k), c) for k, c in dev.most_common(20)]
        top_h = [(str(k), c) for k, c in host.most_common(20)]
        edge = top_h[-1][1]
        if [c for _, c in top_d] != [c for _, c in top_h] or \
                [kv for kv in top_d if kv[1] > edge] != \
                [kv for kv in top_h if kv[1] > edge]:
            raise AssertionError(f"{name}: most_common(20) differs")
        lines.append(f"{name}: {n_reads} reads -> {len(dev)} unique, top "
                     f"count {top_d[0][1]}; {dev_wall}; {host_wall}")
        tables[name] = (dev, host, dev_rows)

    # File 3: the materialized dicts, and the ASCII-matrix path (kernel A).
    dev, host, _ = tables["1m_0-300nt"]
    want = {str(k): v for k, v in host.to_counter().items()}
    if {str(k): v for k, v in dev.to_counter().items()} != want:
        raise AssertionError("1m_0-300nt: to_counter() differs from host")
    mat, lengths = read_fastq_matrix(files["1m_0-300nt"][0])
    t0 = time.perf_counter()
    got = main_path.run("count", count_matrix_device, mat, lengths,
                        device="cuda")
    matrix_wall = time.perf_counter() - t0
    found["matrix_pack_validate"] = main_path.last["pack_validate"]
    if {str(k): v for k, v in got.items()} != want:
        raise AssertionError("count_matrix_device differs from host")
    lines.append(f"1m_0-300nt count_matrix_device: {matrix_wall:.3f} s, "
                 f"{len(got)} keys equal to host")
    del mat, got, want

    # File 1 in 256 MiB byte-range slices: the streamed path.
    path, _ = files["10m_15-32nt"]
    os.environ["SHORTSEQ_TORCH_STREAM_BYTES"] = str(256 << 20)
    try:
        streamed, s_wall = count(path, "device")
    finally:
        del os.environ["SHORTSEQ_TORCH_STREAM_BYTES"]
    whole = tables["10m_15-32nt"][2]
    for width, rows in live_rows(streamed).items():
        if not all(np.array_equal(x, y) for x, y in zip(rows, whole[width])):
            raise AssertionError("streamed table differs from whole-file")
    lines.append(f"10m_15-32nt streamed in "
                 f"{-(-os.path.getsize(path) // (256 << 20))} slices: "
                 f"{s_wall}, equal to the whole-file table")

    # The CLI on file 2, against the in-process table's top 20.
    path, _ = files["2m_150nt_zipf"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "shortseq_torch", "count", str(path),
         "--engine", "device", "--top", "20"], cwd=ROOT, capture_output=True,
        timeout=900)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"count CLI exit {proc.returncode}: "
                           f"{proc.stderr.decode(errors='replace')}")
    want = "".join(f"{k}\t{v}\n"
                   for k, v in tables["2m_150nt_zipf"][0].most_common(20))
    if proc.stdout.decode() != want:
        raise AssertionError("count CLI top 20 differs from the API's")
    lines.append(f"2m_150nt_zipf CLI --top 20: {cli_wall:.3f} s, equal to "
                 "the API's")
    # Phase sharded counts files 1 and 2 again and holds its tables to
    # these device tables.
    found["files"] = files
    found["tables"] = {name: (t[0], t[2]) for name, t in tables.items()
                       if name != "1m_0-300nt"}
    for line in lines:
        print("  " + line, flush=True)
    return f"files written in {gen_s:.3f} s; all checks passed"


def phase_batch(torch, main_path, workdir, found):
    import numpy as np

    import shortseq_torch as st
    from shortseq_torch.api.counter import count_indexed_host_table
    from shortseq_torch.batch import _rows_to_str
    from shortseq_torch.io.fastq import read_fastq_index, read_fastq_matrix
    from shortseq_torch.ops import bitpack, hamming, pairwise

    run = main_path.run
    timer = Timer(torch)
    lines = []
    n, length = 2_000_000, 150
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    mols = alpha[rng.integers(0, 4, size=(200_000, length), dtype=np.uint8)]
    reads = mols[zipf_pick(rng, 200_000, n)]
    del mols
    path = Path(workdir) / "batch_150nt.fastq"
    write_fastq(path, reads)
    mat, lengths = read_fastq_matrix(path)
    assert mat.shape == (n, 160), mat.shape

    def wall(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run("batch", fn, *args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    b, pack_s = wall(st.PackedBatch.from_matrix, mat, lengths, device="cuda")
    lines.append(f"from_matrix [{n},160]: {pack_s:.3f} s")

    # decode, then its three parts apart: kernel E (CUDA events), the copy
    # of 16 B per word to the host, and the host's list of str.
    seqs, decode_s = wall(b.decode)
    if "".join(seqs).encode() != reads.tobytes():
        raise AssertionError("decode() differs from the written reads")
    e_ms = timer([lambda: bitpack.unpack_ascii(b.words)])[0]
    ascii_d = bitpack.unpack_ascii(b.words)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ascii_h = ascii_d.cpu().numpy()
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _rows_to_str(ascii_h, lengths)
    host_s = time.perf_counter() - t0
    lines.append(f"decode: {decode_s:.3f} s, {n * length / decode_s:.4g} "
                 f"nt/s; kernel E {e_ms:.4f} ms, copy {copy_s:.3f} s "
                 f"({ascii_h.nbytes / copy_s / 1e9:.2f} GB/s), host strings "
                 f"{host_s:.3f} s")
    del ascii_d, ascii_h

    # trim and trim_ragged against Python slices on 10,000 rows.
    sample = np.sort(rng.choice(n, 10_000, replace=False))
    want = [seqs[i] for i in sample]
    t, trim_s = wall(b.trim, 8, 100)
    if run("batch", t[sample].decode) != [s[8:108] for s in want]:
        raise AssertionError("trim(8, 100) differs from Python slices")
    starts = rng.integers(0, 41, size=n).astype(np.int32)
    keep = rng.integers(60, 151, size=n).astype(np.int32)
    t, ragged_s = wall(b.trim_ragged, starts, keep)
    if run("batch", t[sample].decode) != [
            s[a:a + k] for s, a, k in zip(want, starts[sample], keep[sample])]:
        raise AssertionError("trim_ragged differs from Python slices")
    del t, seqs
    lines.append(f"trim(8, 100): {trim_s:.3f} s, trim_ragged: "
                 f"{ragged_s:.3f} s; 10,000 rows equal to Python slices")

    # hamming against a copy with known substitutions (0-5 per row).
    k = rng.integers(0, 6, size=n)
    hit = np.zeros((n, length), bool)
    hit[np.repeat(np.arange(n), k), rng.integers(0, length, size=k.sum())] = 1
    change = np.arange(256, dtype=np.uint8)
    change[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"CGTA",
                                                             np.uint8)
    mat2 = mat.copy()
    sub = mat2[:, :length]
    sub[hit] = change[sub[hit]]
    b2 = run("batch", st.PackedBatch.from_matrix, mat2, lengths,
             device="cuda")
    d, ham_s = wall(b.hamming, b2)
    if not np.array_equal(d.cpu().numpy(), hit.sum(axis=1)):
        raise AssertionError("hamming differs from the known substitutions")
    lines.append(f"hamming: {ham_s:.3f} s, {int(hit.sum())} known "
                 "substitutions found")
    del b2, d, hit, mat2, sub

    # pairwise: a 4096-row block against 131,072 rows (a 2 GB slab), by
    # the calibrated choice, which is never the plain version.
    block, table = b[:4096], b[:131072]
    before = dict(pairwise.pairwise_hamming_auto.paths)
    d, pair_s = wall(block.pairwise, table)
    taken = {k: v - before[k]
             for k, v in pairwise.pairwise_hamming_auto.paths.items()
             if v != before[k]}
    if set(taken) not in ({"tiled"}, {"onehot"}):
        raise AssertionError(f"pairwise took {taken}")
    found["batch_pairwise"] = taken
    if not torch.equal(d, pairwise.hamming_pairwise_tiled(block.words,
                                                          table.words)):
        raise AssertionError("pairwise differs from kernel B")
    if not torch.equal(d[:8], hamming.hamming_pairwise(block.words[:8],
                                                       table.words)):
        raise AssertionError("pairwise differs from the plain version")
    del d
    slab = timer([lambda: pairwise.hamming_pairwise_tiled(block.words,
                                                          table.words),
                  lambda: hamming.hamming_pairwise_onehot(block.words,
                                                          table.words)],
                 runs=3)
    for w in (1, 2, 64):
        pairwise.calibrate_pairwise(w, "cuda")
    with open(pairwise._calib_file()) as f:
        calib = json.load(f)
    per_width = "; ".join(
        f"W={key.rsplit('/w', 1)[1]}: {e['winner']} ("
        + ", ".join(f"{c} {v * 1e3:.4f} ms" for c, v in e["times"].items())
        + ")" for key, e in sorted(calib.items(),
                                   key=lambda kv: int(kv[0].rsplit("w")[-1])))
    if any(e["winner"] == "plain" for e in calib.values()):
        raise AssertionError(f"calibration picked plain: {calib}")
    lines.append(f"pairwise [4096]x[131072] W=10 by {list(taken)[0]}: "
                 f"{pair_s:.3f} s incl. calibration; kernel B "
                 f"{slab[0]:.4f} ms, onehot {slab[1]:.4f} ms")
    lines.append(f"calibration at [512]x[16384]: {per_width}")

    # counts() against the host engine's table of the same file.
    counts, counts_s = wall(b.counts)
    host = count_indexed_host_table(*read_fastq_index(path)).to_counter()
    if counts != host or sum(counts.values()) != n:
        raise AssertionError("counts() differs from the host engine")
    lines.append(f"counts(): {counts_s:.3f} s, {len(counts)} keys equal to "
                 "the host engine's")
    del counts, host

    # pack_batch on Python strings, and its invalid-base error.
    strs = [reads[i].tobytes().decode() for i in range(200_000)]
    pb, seqs_s = wall(st.pack_batch, strs, device="cuda")
    if not torch.equal(pb.words, b.words[:200_000]):
        raise AssertionError("pack_batch words differ from from_matrix's")
    try:
        run("batch", st.pack_batch, strs[:1000] + ["ACGN" * 10],
            device="cuda")
    except Exception as e:
        if "Unsupported base character: N" not in str(e):
            raise
    else:
        raise AssertionError("pack_batch accepted an N")
    lines.append(f"pack_batch of 200,000 strings: {seqs_s:.3f} s, equal to "
                 "from_matrix; invalid base raised")

    objs, obj_s = wall(b[:100_000].to_objects)
    if objs != [st.pack(s) for s in strs[:100_000]]:
        raise AssertionError("to_objects() differs from pack(str)")
    lines.append(f"to_objects() of 100,000 rows: {obj_s:.3f} s")
    del objs, strs, pb, b

    # umi_adjacency on 8,192 12-nt UMIs, half one substitution from the
    # other half.
    umis = rand_umis(4096, 12, seed=4)
    umis += [u[:5] + (b"A" if u[5:6] != b"A" else b"C") + u[6:] for u in umis]
    ub = st.pack_batch(umis, device="cuda")
    adj, adj_s = wall(st.umi_adjacency, ub.words, ub.lengths.cpu().numpy(), 1)
    want = (hamming.hamming_pairwise(ub.words, ub.words) <= 1).cpu().numpy()
    if not np.array_equal(adj, want):
        raise AssertionError("umi_adjacency differs from the plain pairwise")
    lines.append(f"umi_adjacency of 8,192 UMIs: {adj_s:.3f} s, "
                 f"{int(adj.sum())} edges incl. self")
    for line in lines:
        print("  " + line, flush=True)
    return "all checks passed"


def phase_sharded(torch, main_path, workdir, found, results):
    """The sharded and distributed count on phase count's files 1 and 2:
    the resumable CLI, a resume after lost spills, the three merge tiers
    under a one-rank NCCL group, DistributedCountTable's reads, K10
    against its plain version, and the lazy table reads (K8) timed."""
    import numpy as np

    from shortseq_torch.config import PipelineConfig
    from shortseq_torch.count import checkpoint
    from shortseq_torch.count.device import unique_count
    from shortseq_torch.count.ingest import packed_buckets
    from shortseq_torch.count.table import (_key_to_rows, _lookup,
                                            _topk_rows, _total)
    from shortseq_torch.dist import count as dc
    from shortseq_torch.dist import mesh as dm
    from shortseq_torch.dist import pipeline as dp
    from shortseq_torch.dist.table import DistributedCountTable
    from shortseq_torch.io.fastq import read_fastq_index, read_fastq_matrix
    from shortseq_torch.ops.lanes import from_numpy_u32

    run = main_path.run
    timer = Timer(torch)
    lines = []
    path1, n1 = found["files"]["10m_15-32nt"]
    path2, n2 = found["files"]["2m_150nt_zipf"]
    dev1, rows1 = found["tables"]["10m_15-32nt"]
    rows2 = found["tables"]["2m_150nt_zipf"][1]

    def same(table, want, what):
        w, lens, cnts = dp._table_to_host(table)
        assert_same_rows({w.shape[1]: (np.asarray(w, np.uint32), lens,
                                       np.asarray(cnts, np.int64))},
                         want, what)

    def timed(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run("sharded", fn, *args, **kwargs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def tier_of(fn, *args):
        before = dict(dc.count_sharded_auto.tiers)
        out, wall = timed(fn, *args)
        taken = [t for t, n in dc.count_sharded_auto.tiers.items()
                 if n != before[t]]
        tiers = found.setdefault("tiers", {})
        for t in taken:
            tiers[t] = tiers.get(t, 0) + 1
        return out, taken, wall

    # 1. The CLI: 8 byte-range shards spilled to a checkpoint directory.
    ck = Path(workdir) / "ck_sharded"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "shortseq_torch", "count", str(path1),
         "--shards", "8", "--checkpoint", str(ck), "--top", "20"], cwd=ROOT,
        capture_output=True, timeout=600)
    cli_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"sharded count CLI exit {proc.returncode}: "
                           f"{proc.stderr.decode(errors='replace')}")
    if proc.stdout.decode() != "".join(f"{k}\t{v}\n"
                                       for k, v in dev1.most_common(20)):
        raise AssertionError("sharded CLI top 20 differs from phase count's")
    spills = sorted(p.name for p in ck.glob("counts_*.npz"))
    if len(spills) != 8:
        raise AssertionError(f"sharded CLI spilled {spills}")
    lines.append(f"CLI count --shards 8 --checkpoint --top 20 on file 1: "
                 f"{cli_wall:.3f} s, equal to phase count's top 20")

    # 2. Resume: 3 of the 8 spills lost, exactly those 3 recounted.
    lost = [checkpoint.shard_path(ck, 0, s) for s in (1, 4, 6)]
    for p in lost:
        p.unlink()
    saved, real_save = [], checkpoint.save_table
    checkpoint.save_table = lambda p, *a: saved.append(p) or real_save(p, *a)
    try:
        table, resume_s = timed(dp.count_fastq_sharded, path1, n_shards=8,
                                config=PipelineConfig(checkpoint_dir=str(ck)))
    finally:
        checkpoint.save_table = real_save
    if sorted(saved) != lost:
        raise AssertionError(f"resume recounted {saved}")
    same(table, rows1, "resumed file 1")
    lines.append(f"resume with 3 of 8 spills lost: {resume_s:.3f} s, 3 "
                 "shards recounted, table equal to the whole-file table")
    del table

    # 3. A one-rank NCCL group: every collective of dist/ runs through it.
    dm.initialize_distributed(init_method=f"file://{workdir}/pg_init",
                              rank=0, world_size=1, device="cuda",
                              timeout=300)
    try:
        mesh = dm.data_mesh(device="cuda")
        backend = torch.distributed.get_backend()
        if not (mesh.distributed and mesh.size == 1 and backend == "nccl"):
            raise AssertionError(f"mesh {mesh}, backend {backend}")
        mat, lens = read_fastq_matrix(path1)
        (t1, ok), taken, wall = tier_of(dc.make_sharded_counter(mesh), mat,
                                        lens)
        if taken != [1] or t1.layout != "scattered" or not bool(ok.all()):
            raise AssertionError(f"make_sharded_counter: tiers {taken}, "
                                 f"{t1.layout}, ok {bool(ok.all())}")
        same(t1, rows1, "make_sharded_counter on file 1")
        lines.append(f"make_sharded_counter [{n1},32] bytes: {wall:.3f} s, "
                     "tier 1, scattered, equal to file 1's table")
        del mat, lens
        table, wall = timed(dp.read_and_count_fastq_distributed, path1,
                            n_shards=4)
        same(table, rows1, "read_and_count_fastq_distributed on file 1")
        lines.append(f"read_and_count_fastq_distributed(n_shards=4): "
                     f"{wall:.3f} s, {table.layout}, equal to file 1's table")
        del table

        # The fallback tiers at capacity factor 0.25 (one rank: every row
        # in bucket 0, a quarter of the rows fit).
        auto = dc.count_sharded_auto(mesh, capacity_factor=0.25)
        bufs = {}
        for name, path, n, want, tier in (
                ("file 2", path2, n2, rows2, 2),
                ("file 1", path1, n1, rows1, 3)):
            (w, ln), = packed_buckets(*read_fastq_index(path))
            w, ln = from_numpy_u32(w).cuda(), torch.from_numpy(ln).cuda()
            bufs[name] = (w, ln)
            ones = torch.ones(n, dtype=torch.int32, device="cuda")
            table, taken, wall = tier_of(auto, w, ln, ones)
            layout = "scattered" if tier < 3 else "prefix"
            if taken != [tier] or table.layout != layout:
                raise AssertionError(f"{name} at 0.25: tiers {taken}, "
                                     f"{table.layout}")
            same(table, want, f"{name} at capacity factor 0.25")
            lines.append(f"count_sharded_auto(0.25) on {name}'s "
                         f"[{n},{w.shape[1]}] words: {wall:.3f} s, tier "
                         f"{tier}, {layout}, exact")
            del table, ones

        # DistributedCountTable on the tier-1 table against CountTable.
        dct = DistributedCountTable(t1, mesh)
        top_d = [(str(k), c) for k, c in dct.most_common(20)]
        top_c = [(str(k), c) for k, c in dev1.most_common(20)]
        edge = top_c[-1][1]
        if [c for _, c in top_d] != [c for _, c in top_c] or \
                [kv for kv in top_d if kv[1] > edge] != \
                [kv for kv in top_c if kv[1] > edge] or \
                any(dev1.get(k) != c for k, c in top_d):
            raise AssertionError("DistributedCountTable.most_common(20)")
        probe = top_c[0][0]
        missing = "ACGT" * 8
        if (len(dct), dct.total()) != (len(dev1), dev1.total()) or \
                dct.get(probe) != dev1.get(probe) or \
                dct.get(missing, -1) != dev1.get(missing, -1) or \
                not np.array_equal(np.sort(dct.values()),
                                   np.sort(dev1.values())):
            raise AssertionError("DistributedCountTable reads differ")
        lines.append(f"DistributedCountTable: len {len(dct)}, total "
                     f"{dct.total()}, most_common(20), get, values equal to "
                     "CountTable's")
        del dct, t1
    finally:
        torch.distributed.destroy_process_group()

    # 4. K10 against its plain version on what the main path gives it at
    # one rank (D = 1: file 1's words at factor 2 in tier 1; both files'
    # words at factor 0.25, raw in tier 1 and pre-deduped in tier 2), and
    # at the D of more ranks.  The JSON line takes the tier-1 shape.
    shapes = []
    for name, n in (("file 1", n1), ("file 2", n2)):
        w, ln = bufs.pop(name)
        ones = torch.ones(n, dtype=torch.int32, device="cuda")
        label = f"{name} [{n},{w.shape[1]}]"
        wide = [(d, 2.0) for d in ((1, 2, 3, 6, 8, 65536)
                                   if name == "file 1" else (8,))]
        shapes.append((label, w, ln, ones, [(1, 0.25)] + wide))
        shapes.append((f"{label} pre-deduped", *unique_count(w, ln, ones)[:3],
                       [(1, 0.25)]))
    results["bucket_send"] = kernel_k10(
        torch, timer, lines, shapes, (f"file 1 [{n1},2]", 1, 2.0))
    del shapes

    # 5. K8, the lazy reads, on file 1's device table (padded to its rows).
    b = dev1._buckets[0]
    q_len, lanes = _key_to_rows(probe)
    q = from_numpy_u32(np.asarray(lanes[:b.width], np.uint32)).cuda()
    t = timer([lambda: _topk_rows(b.words, b.lengths, b.counts, 20),
               lambda: _lookup(b.words, b.lengths, b.counts, q, q_len),
               lambda: _total(b.counts)])
    bounds = [bound([b.counts], []), bound([b.words, b.lengths, b.counts],
                                           []), bound([b.counts], [])]
    lines.append("K8 on file 1's table [" + f"{b.words.shape[0]},"
                 f"{b.width}]: " + "; ".join(
                     f"{name} {ms:.4f} ms, {bound_text(bd)}"
                     for name, ms, bd in zip(("most_common(20)", "get",
                                              "total"), t, bounds)))
    for line in lines:
        print("  " + line, flush=True)
    return "all checks passed"


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
    from shortseq_torch.api import counter
    from shortseq_torch.dist import pipeline
    from shortseq_torch.io import native
    from shortseq_torch.ops import pairwise
    from shortseq_torch.umi import dedup

    dev, results = {}, {}
    phase("device", phase_device, torch, dev)
    phase("build", phase_build)
    phase("kernels", phase_kernels, torch, results)

    # The main path: kernel launches and the paths taken, counted.
    main_path = MainPath()
    paths, found = {}, {}
    for module, name in ((dedup, "_dedup_umi_matrix"),
                         (dedup, "_dedup_reads_matrix"),
                         (counter, "count_indexed_device_table"),
                         (counter, "_read_and_count_table_streamed"),
                         (counter, "_h2d_chunks"),
                         (pipeline, "count_fastq_sharded"),
                         (pipeline, "read_and_count_fastq_distributed")):
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            if _name != "_h2d_chunks" or out == 4:
                paths[_name] = paths.get(_name, 0) + 1
            return out

        setattr(module, name, counted)
    with tempfile.TemporaryDirectory() as workdir:
        # Every run calibrates the pairwise selector afresh, into workdir.
        pairwise._calib_file = lambda: str(Path(workdir) / "calib.json")
        phase("umi_scale", phase_umi_scale, torch, main_path)
        phase("umi_cli", phase_umi_cli, torch, main_path, workdir)
        phase("count", phase_count, torch, main_path, workdir, found)
        phase("batch", phase_batch, torch, main_path, workdir, found)
        phase("sharded", phase_sharded, torch, main_path, workdir, found,
              results)
        del found["files"], found["tables"]
    launches = main_path.launches

    def counters():
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
        if main_path.by_phase["count"]["unique_count"] == 0:
            raise AssertionError("kernel D never launched in phase count")
        umi = {p: main_path.by_phase[p] for p in ("umi_scale", "umi_cli")}
        quiet = [p for p, n in umi.items() if n["neighbor_lists_fused"] == 0]
        if quiet:
            raise AssertionError(f"kernel H never launched in {quiet}")
        if not (umi["umi_scale"]["pairwise_hamming"]
                and umi["umi_scale"]["neighbor_extract"]):
            raise AssertionError("kernels B + C never launched in the "
                                 "overflow tier of phase umi_scale")
        if found["matrix_pack_validate"] == 0:
            raise AssertionError("kernel A never launched in "
                                 "count_matrix_device")
        in_batch = main_path.by_phase["batch"]
        quiet = [k for k in ("pack_words", "unpack_ascii", "trim_words",
                             "hamming_rows", "pack_validate")
                 if in_batch[k] == 0]
        if quiet:
            raise AssertionError(f"never launched in phase batch: {quiet}")
        if "tiled" in found["batch_pairwise"] and \
                in_batch["pairwise_hamming"] == 0:
            raise AssertionError("pairwise chose tiled but B never launched")
        in_sharded = main_path.by_phase["sharded"]
        if in_sharded["bucket_send"] == 0:
            raise AssertionError("K10 never launched in phase sharded")
        if sorted(found["tiers"]) != [1, 2, 3]:
            raise AssertionError(f"merge tiers taken: {found['tiers']}")
        if native.get_lib() is None:
            raise AssertionError("native host library not loaded")
        want = {"_dedup_umi_matrix", "_dedup_reads_matrix",
                "count_indexed_device_table",
                "_read_and_count_table_streamed", "_h2d_chunks",
                "count_fastq_sharded", "read_and_count_fastq_distributed"}
        if set(paths) != want:
            raise AssertionError(f"paths not all taken: {paths}")
        return (f"launches {launches}, in phase umi_scale "
                f"{umi['umi_scale']}, in phase umi_cli {umi['umi_cli']}, "
                f"in phase count "
                f"{main_path.by_phase['count']}, in phase batch {in_batch} "
                f"(pairwise path {found['batch_pairwise']}), in phase "
                f"sharded {in_sharded} (merge tiers {found['tiers']}), A in "
                f"count_matrix_device {found['matrix_pack_validate']}; "
                f"paths {paths} (_h2d_chunks: buckets sent in 4 chunks)")

    phase("counters", counters)
    kernels = [dict(name=name, route="cuda", source=r.get("source", SOURCE),
                    replaces=r["replaces"], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"])
               for name, r in results.items()]
    print(json.dumps({"kernels": kernels}))
    print(dev["smi"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
