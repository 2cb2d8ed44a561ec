#!/usr/bin/env python3
"""Drive shortseq_torch's slices once on one CUDA card and check them.

Usage (from the repository root, one card):  python3 chip_smoke.py

Phases, one line each; any failure raises and exits nonzero:
  device     a CUDA card is present; its name and power limit (nvidia-smi)
  build      kernels A to I, K10 and S (nvcc, sm_90a, one process per
             source),
             the host library and the object extension (g++) from this
             checkout's sources, all started together, with the seconds
             each took, and the object backend
  kernels    each kernel against its plain PyTorch version on the card at
             the slices' shapes (integers: exact equality), with median
             CUDA-event times over 7 runs (3 for the largest), L2 flushed
             before each run, each beside its bound (bytes at 3.35 TB/s or
             popcounts at 4.18e12/s, whichever is longer), and the card's
             SM clock and power draw sampled throughout; A (pack +
             validate) at its main-path shapes: [10M, 8] lanes (random
             lengths, 1% bad bytes; with and without pad_valid; the JSON
             line), the 12-nt UMIs of dedup_umis, each width class of
             count_matrix_device on file 3, then exact at w = 1, 3, 5, 10
             words, N = 1 and 33, with its device time (torch.profiler)
             and its wrapper's host time a call; B at
             [2688] x [102144] W = 2, [4096] x [131072] W = 10 and
             [512] x [16384] W = 6 and 64, each also against the one-hot
             product; C (kernel_c) on B's band slab at k = 16 and 128 and
             on the overflow tier's [256] and [706] x [7424] slabs of phase
             umi_scale's fan UMIs at k = 128 (706 rows: its main-path
             batch), each also at 1, 2, 4 and 8 column segments a row, and
             exact on 96 edge cases (c_edge_slab: U = 1001, 1003, 1004,
             7424; k = 1, 16, 128; rows with no hit, exactly k, k + 5
             ending late; own and pad columns; a slab off 16-byte
             alignment), with its wrapper's host time; H on the band
             at k = 16 and 128 (also against B + C) and at the main path's
             [100000] x [102144] (also against B + C over 38 bands); for
             B, C and H also each launch's device time (torch.profiler),
             which leaves out the wrapper's host time that the CUDA
             events include;
             for D also its edge cases (tile edges from
             GROUP_TILE_ROWS, poison, int32 wraps, small n_out, PAD
             rows, N = 1, W = 1 and 5), a one-key shape, each of its
             launches' device times (torch.profiler), the sort and the
             whole unique_count (sort + D), beside torch.unique of the
             (length, row) keys with return_counts at [10M, 2] and
             [2M, 64] (the library call for unit weights; its groups
             checked against D's); kernel I (the row hash of
             unique_count's hash path, rows over 6 lanes) exact at [2M,
             64], [2M, 10] and [100003, 7] off 16-byte alignment with PAD
             rows at seeds 0 and 7, D with its keys on collision_cases,
             I's event and device times at [2M, 64] Zipf beside its bound
             with the hash path's sorts, D, the whole unique_count, the
             lex path and torch.unique, a forced collision (seed 0
             colliding: the CPU's table; every seed: OverflowError), and
             unique_count on the card equal to the CPU's at [2M, 64] and
             [100003, 7]; kernel S (kernel_s, unique_count's row sort:
             histograms, the plan on the card, then one launch a
             candidate digit, no host read) exact against its plain
             version and the library path on 30 edge cases
             (sort_edge_cases: N = 1, 100, a tile +- 1, tile counts
             around the card's resident blocks, every key equal, all
             PAD, lengths 0 and 1024 beside PAD, only the length
             varying, a single varying digit, W = 1, 3, 5, 6, 7, lanes
             with bit 31 set, heavy duplicates, a Zipf run of one key
             over 40 tiles, live lengths above 2046), its pass table
             against the plain one, and at the main path's shapes (file
             1's words [10M, 2], one of its 8 shards [1.25M, 2], [1M,
             6], and on the hash path [2M, 64] Zipf and [2M, 10]), equal
             to the library path's torch.sort there too, with its event
             times and each launch's device time in order (the skipped
             candidates' too), its bound, the pass model, the plain and
             library times and unique_count with either sort; sort_rows,
             _sort_keys and unique_count's key path under
             torch.cuda.set_sync_debug_mode("error"); D on rows already
             in S's order against D through S's perm at [10M, 2] and
             [1.25M, 2]; and unique_count with torch.sort stubbed to
             raise equal to the CPU's at every one of those shapes;
             kernel A's pack-only mode at [2M, 40]
             (150-nt rows; device time; exact at w = 1, 3, 5, 9, 10
             words), E at [2M, 10], F (kernel_f) static (8, 100) (one
             launch a call) and ragged at [2M, 10] with its wrapper's host
             time and 216 exact edge cases (f_edge_cases), G (kernel_g)
             at [2M, 10], [262144, 64] and [2M, 1], each with its device
             time, its wrapper's host time and its exact edge cases
             (g_edge_cases: N = 1 to 4097 around a block's rows, W = 1 to
             64, row views off 16 bytes, distances 0 and 16 W), and the
             one-hot pairwise product against B at [512] x [16384], W = 1,
             2, 10, 64
  umi_scale  dedup_umis on 100,000 unique 12-nt UMIs x 3 (directional,
             threshold 1): a valid partition, the neighbour lists' wall
             and the host's split of them timed alone, a 512-row slab of
             neighbour lists against the plain pairwise check, a
             5,000-unique problem identical to device="cpu", and 8,200
             UMIs (7,400 unique) in error fans at threshold 2 (rows over
             the main pass's cap, so the overflow tier runs B + C in
             706-row batches, fetched once) identical to device="cpu"
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
             against a copy with known substitutions (kernel G's device
             time beside the wall), a 4096-row block
             against 131,072 rows through the calibrated pairwise selector
             (the choice, never plain, and its times per lane width),
             counts() equal to the host engine's table; pack_batch on
             200,000 strings equal to from_matrix, and its invalid-base
             error; to_objects() on 100,000 rows equal to pack(str);
             umi_adjacency on 8,192 12-nt UMIs against the plain pairwise
  folded     the JAX package's row-folded and padded names through kernel
             A: pack_and_validate_folded, pack_folded and
             pack_validate_padded at bench.py's headline shape (2^18 rows
             x 160 bytes, fold 4, unfold=False, pad_valid) and at
             [10M, 8] lanes (fold 16, unfold True and False), each equal
             to the plain pack exactly, then timed
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
             each equal to phase count's table array for array, and
             DistributedCountTable's
             len, total, most_common(20), get and values equal to
             CountTable's; K10 against its plain version (edge cases at
             its plan's tile and look-back edges, D = 1024 and 1025 on
             either side of the one-pass limit, pre-deduped tables, the
             capacity edge, N = 1, rows off 16-byte alignment; then the
             main path's D = 1 on both files' words at factor 0.25, raw
             and pre-deduped, file 1's [10M,2] words at D = 1, 2, 3, 6, 8,
             65536 and file 2's [2M,64] at D = 8, timed with CUDA events
             and torch.profiler, its wrapper's host time a call); the lazy
             reads (K8) on file 1's table timed
  umi_mesh   the sharded UMI dedup under a one-rank NCCL group (file://
             init): dedup_umis(mesh=) on umi_scale's 300,000 UMIs equal to
             the no-mesh call (both walls, median of 3 in turns),
             dedup_reads(mesh=) on umi_cli's 1M reads equal to no mesh,
             umi_scale's fan UMIs at threshold 2 under the mesh (H, B and
             C launched) equal to device="cpu"; kernel H at the row bands
             of 2, 4 and 8 ranks (UMI_BANDS), each exact against the
             whole-matrix call, with event and device times beside its
             popcount bound; A, E, G and unique_count (D and S, and I at 8
             lanes) under torch.profiler, each launch inside its ssq.*
             range, and A's and G's wrapper
             host time with and without the range; count's file 3 counted
             as a fresh process's first call, 3 times with the CUDA warmup
             thread and 3 without, in turns
  counters   kernels A to I, K10 and S all launched while phases umi_scale,
             umi_cli, count, batch, folded, sharded and umi_mesh drove the
             main path (counts reset just before each run), H in umi_scale,
             umi_cli and umi_mesh, B + C in the overflow tier of umi_scale
             and umi_mesh, D during count, I in count and batch, S in
             count, batch and sharded, A in
             count_matrix_device, A's pack-only mode, E, F and G in batch,
             A 5 times and its pack-only mode 3 times in folded,
             K10 in sharded, and the pairwise choice in batch; all three
             merge tiers taken; the native host library loaded, the UMI
             matrix paths, the count path's device engine, 4-chunk
             transfer and streamed slices, count_fastq_sharded,
             read_and_count_fastq_distributed and neighbors_sharded_step
             all taken

Before the last line it prints a JSON object of per-kernel results; the
last line is {"ok": true, "device": {"platform": "gpu", ...}}.  Random
data comes from numpy seeds, so every run checks the same inputs.
"""

from __future__ import annotations

import functools
import itertools
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
SOURCE_SORT = "shortseq_torch/csrc/sort.cu"

# The least time a kernel could take (bound_ms): the larger of its bytes
# (each input read once, each output written once) at the H100 SXM's HBM
# rate and its popcounts at __popc's rate (16 per SM per clock, 132 SMs at
# 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
POPC_PER_S = 132 * 16 * 1.98e9
# The H100 SXM's dense float16 tensor-core peak (the one-hot product's).
FP16_FLOPS_PER_S = 989e12


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
        return [statistics.median(t) for t in self.samples(fns, runs)]

    def samples(self, fns, runs=7):
        """Each callable's CUDA-event ms of every run, in turns."""
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
        return times


def host_us(torch, fn, calls=300):
    """Mean host microseconds a call of fn, calls issued back to back with
    no synchronize between them: at a shape whose device work is shorter
    than the host's, the wrapper's own cost (checks, allocations, the
    launch)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


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


def bound(inputs, outputs, popc=0, nbytes=0):
    """(bound_ms, bound_by) of one call: its bytes (the tensors', plus
    `nbytes` that only the data says it needs) at HBM_BYTES_PER_S against
    its popcounts at POPC_PER_S, whichever takes longer."""
    nbytes += sum(t.numel() * t.element_size()
                  for t in (*inputs, *outputs))
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

    from shortseq_torch.ops import hamming, pairwise
    from shortseq_torch.umi import dedup

    timer = Timer(torch)
    rng = np.random.default_rng(0)

    results["pack_validate"] = kernel_a(torch, timer, lines)

    # B: all-pairs hamming at its callers' shapes, each against plain and
    # against the one-hot float16 product, its yardstick (library_ms):
    # a 2688-row band of 12-nt UMIs against all 102144 padded rows (W = 2;
    # the UMI main pass before kernel H, and H's band below);
    # PackedBatch.pairwise's 4096-row block against 131072 rows of 150 nt
    # (W = 10; plain in 256-row chunks, whose broadcast would need 21 GB);
    # the calibration shape [512] x [16384] at W = 6 and 64.
    words, lens_d, gids_d, rows_d = umi_band(torch, rng)
    u_pad, block, lo = len(words), BAND_ROWS, BAND_LO
    a = words[lo:lo + block]
    slab = torch.empty((block, u_pad), dtype=torch.int32, device="cuda")

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
        # The one-hot product's own bound: its [n, 64 w] x [64 w, m]
        # float16 multiply-adds at the tensor cores' dense peak, against
        # the same operands' and result's bytes.
        hot = max(bound([a, b], [got])[0],
                  2 * n * len(b) * 64 * w / FP16_FLOPS_PER_S * 1e3)
        split = launch_split(torch, kernel, ("pairwise",))
        lines.append(f"B {name}: {t[0]:.4f} ms, plain {t[1]:.4f} ms, "
                     f"one-hot {t[2]:.4f} ms (its bound {hot:.4f} ms); "
                     f"{bound_text(bnd)}; {split}")
        return err, t, bnd

    errs = [b_case("[2688]x[102144] W=2", a, words, out=slab)[0]]
    for w in (6, 64):
        errs.append(b_case(f"[512]x[16384] W={w}",
                           card_lanes(torch, rng, 512, w),
                           card_lanes(torch, rng, 16384, w))[0])
    aw, bw = (card_lanes(torch, rng, n, 10) for n in (4096, 131072))
    err, t, bnd = b_case("[4096]x[131072] W=10", aw, bw, chunk=256, runs=3)
    del aw, bw
    torch.cuda.empty_cache()
    results["pairwise_hamming"] = dict(
        replaces="shortseq_tpu/ops/pallas_kernels.py:76",
        max_abs_err=max(errs + [err]), ms=t[0], plain_ms=t[1],
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=t[2])

    results["neighbor_extract"] = kernel_c(
        torch, timer, lines, (words, lens_d, gids_d, rows_d), slab)
    sl = slice(lo, lo + block)
    args = (slab, lens_d[sl], gids_d[sl], rows_d[sl], lens_d, gids_d, 3)

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
    results["row_hash"] = kernel_i(torch, timer, rng, lines)
    results["row_sort"] = kernel_s(torch, timer, rng, lines)
    results.update(batch_kernels(torch, timer, rng, lines))


def kernel_a(torch, timer, lines):
    """Kernel A (pack + validate) against its plain version, exact, at the
    main path's shapes, timed (CUDA events and torch.profiler): file 1's
    [10M, 32] byte rows in make_sharded_counter ([10M,8] lanes, random
    lengths, 1% bad bytes; with and without pad_valid; the JSON line's
    shape), dedup_umis' 100,000 12-nt UMIs (_pack_validate_matrix: [100000,
    8], zero past 12), and each width class of count_matrix_device on
    file 3's 1M reads of 0-300 nt ([.., 8], [.., 24], [.., 256]); then,
    exact only, the widths whose rows a power-of-two thread group left
    idle (w = 1, 3, 5, 10 words) and the shapes A was first checked at
    ([102144,8] timed too).  Data is drawn on the card from a seeded
    generator: 320 MB of bytes at 10M rows."""
    from shortseq_torch.ops import bitpack

    gen = torch.Generator(device="cuda").manual_seed(21)
    alpha = torch.tensor(list(b"ACGT"), dtype=torch.uint8, device="cuda")

    def rows(n, width, lo, hi, bad=0.01):
        """[n, width // 4] int32 lanes of ACGT bytes, zero past a length
        drawn from [lo, hi], a fraction `bad` of all bytes random."""
        codes = torch.randint(0, 4, (n, width), dtype=torch.uint8,
                              device="cuda", generator=gen)
        mat = alpha[codes.long()]
        del codes
        lens = torch.randint(lo, hi + 1, (n,), dtype=torch.int32,
                             device="cuda", generator=gen)
        mat[torch.arange(width, device="cuda")[None, :] >= lens[:, None]] = 0
        if bad:
            hit = torch.rand((n, width), device="cuda", generator=gen) < bad
            mat[hit] = torch.randint(0, 256, (int(hit.sum()),),
                                     dtype=torch.uint8, device="cuda",
                                     generator=gen)
        return mat.view(torch.int32), lens

    def case(name, x, ln, pad_valid, timed):
        want = bitpack.pack_and_validate_plain(x, ln, pad_valid)
        err = exact(f"A {name} pad_valid={pad_valid}",
                    bitpack.pack_and_validate_u32(x, ln, pad_valid), want)
        if not timed:
            return err, None
        bnd = bound([x, ln], want)
        del want
        ms, plain_ms = timer([
            lambda: bitpack.pack_and_validate_u32(x, ln, pad_valid),
            lambda: bitpack.pack_and_validate_plain(x, ln, pad_valid)])
        split = launch_split(
            torch, lambda: bitpack.pack_and_validate_u32(x, ln, pad_valid),
            ("pack",))
        lines.append(f"A {name} pad_valid={pad_valid}: {ms:.4f} ms, plain "
                     f"{plain_ms:.4f} ms; {split}; {bound_text(bnd)}")
        return err, (ms, plain_ms, bnd)

    errs, main = [], None
    x, ln = rows(10_000_000, 32, 0, 32)
    for pad_valid in (False, True):
        err, t = case("[10M,8] (make_sharded_counter)", x, ln, pad_valid,
                      True)
        errs.append(err)
        main = main or t
    del x, ln
    x, ln = rows(100_000, 32, 12, 12, bad=0)
    errs.append(case("[100000,8] 12-nt UMIs (dedup_umis)", x, ln, False,
                     True)[0])
    # File 3's width classes: <= 32, 33-96 and 97-300 nt of 0-300.
    for n, width, lo, hi in ((109_635, 32, 0, 32), (212_625, 96, 33, 96),
                             (677_740, 1024, 97, 300)):
        x, ln = rows(n, width, lo, hi, bad=0)
        errs.append(case(f"[{n},{width // 4}] (count_matrix_device)", x, ln,
                         False, True)[0])
    for w in (1, 3, 5, 10):
        x, ln = rows(100_003, 16 * w, 0, 16 * w)
        for pad_valid in (False, True):
            errs.append(case(f"[100003,{4 * w}]", x, ln, pad_valid, False)[0])
    for n, w4 in ((102144, 8), (8192, 24), (4096, 256), (1, 4), (33, 12)):
        x, ln = rows(n, 4 * w4, 0, 4 * w4)
        for pad_valid in (False, True):
            errs.append(case(f"[{n},{w4}]", x, ln, pad_valid,
                             n == 102144 and not pad_valid)[0])
    x, ln = rows(1024, 32, 0, 32)
    us = host_us(torch, lambda: bitpack.pack_and_validate_u32(x, ln))
    lines.append("A: every case exact (w = 1, 3, 5, 10 words, N = 1 and 33 "
                 f"included); wrapper host time at [1024,8] {us:.1f} us a "
                 "call")
    return dict(replaces="shortseq_tpu/ops/bitpack.py:330",
                max_abs_err=max(errs), ms=main[0], plain_ms=main[1],
                bound_ms=main[2][0], bound_by=main[2][1], library_ms=None)


BAND_ROWS, BAND_LO = 2688, 2688 * 7   # the UMI band of B, C and H


def umi_band(torch, rng):
    """102,144 random 12-nt UMIs packed on the card (kernel A), the last
    500 of them pad rows (length -1, as _neighbor_lists pads), in two
    random groups: threshold 3 then gives rows ~20 neighbours, so a
    k = 16 cap truncates.  Returns (words, lengths, gids, row ids)."""
    import numpy as np

    from shortseq_torch.ops import bitpack

    u_pad = 102144
    umis = np.frombuffer(b"".join(rand_umis(u_pad, 12, seed=2)),
                         np.uint8).reshape(u_pad, 12)
    mat = np.zeros((u_pad, 32), np.uint8)
    mat[:, :12] = umis
    lens = np.full(u_pad, 12, np.int32)
    words, ok = bitpack.pack_and_validate_rows(mat.view(np.uint32), lens,
                                               device="cuda")
    assert bool(ok.all())
    lens_d = torch.from_numpy(lens).cuda()
    lens_d[-500:] = -1
    gids_d = torch.from_numpy(
        rng.integers(0, 2, size=u_pad).astype(np.int32)).cuda()
    rows_d = torch.arange(u_pad, dtype=torch.int32, device="cuda")
    return words, lens_d, gids_d, rows_d


def c_edge_slab(u, k, seed, threshold=1):
    """Kernel C's edge rows on a [16, u] slab (numpy int32: dist, a_len,
    a_gid, a_rows, len, gid): row 0 has no hit, row 1 exactly k spread
    over the row, row 2 k + 5 at the row's end (the k-th hit in a late
    segment), row 3 a hit at the first and the last column, row 4 every
    matching column, the rest random.  Every row's own column would be a
    hit, and the own columns spread over the row (one in every segment);
    about 10% of the columns are pad (length -1, distance 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    b = 16
    lengths = np.where(rng.random(u) < 0.1, -1, 12).astype(np.int32)
    gids = rng.integers(0, 2, size=u).astype(np.int32)
    a_rows = np.linspace(0, u - 1, b).astype(np.int32)
    lengths[a_rows] = 12
    gids[[0, u - 1]] = gids[a_rows[3]]
    a_len = np.full(b, 12, np.int32)
    a_gid = gids[a_rows]
    dist = rng.integers(0, 4, size=(b, u)).astype(np.int32)
    for r in range(5):
        ok = (lengths == 12) & (gids == a_gid[r])
        ok[a_rows[r]] = False
        cols = np.flatnonzero(ok)
        dist[r] = threshold + 1
        if r == 1:
            dist[r, cols[np.linspace(0, len(cols) - 1, k).astype(int)]] = 0
        elif r == 2:
            dist[r, cols[-(k + 5):]] = threshold
        elif r == 3:
            dist[r, [0, u - 1]] = 0
        elif r == 4:
            dist[r, cols] = 0
    dist[:, lengths < 0] = 0
    dist[np.arange(b), a_rows] = 0
    return dist, a_len, a_gid, a_rows, lengths, gids


def pack_umis(umis):
    """A list of UMIs packed on the card as dedup_umis packs them (kernel
    A): ([U, 2] words, [U] numpy int32 lengths)."""
    import numpy as np

    from shortseq_torch.umi import dedup

    mat, lengths = dedup._padded_rows(umis)
    lengths = lengths.astype(np.int32)
    return dedup._pack_validate_matrix(mat, lengths, "cuda"), lengths


def fan_words(torch):
    """Phase umi_scale's 7,400 unique fan UMIs (threshold 2: every row
    over the main pass's cap of 16), packed on the card: ([U, 2] words,
    [U] numpy lengths)."""
    return pack_umis(list(dict.fromkeys(fan_umis(200, 12, seed=5))))


def kernel_c(torch, timer, lines, band, slab=None, extras=True):
    """Kernel C against its plain version, exact, timed (CUDA events, all
    before any torch.profiler run, then each case's device time): on B's
    slab of the UMI band at k = 16 and 128 (threshold 3; rows over k), and
    at the overflow tier's slabs on phase umi_scale's 7,400 unique fan
    UMIs (threshold 2, k = 128): batches of 256 rows, of 706 (an L2-sized
    21 MB slab) and of the rows a batch of the tier takes now (the JSON
    line's shape).  With `extras`, also c_edge_slab's rows at U = 1001,
    1003, 1004 and 7424, k = 1, 16 and 128, at 0 (the kernel's choice), 1,
    3 and 8 segments a row, each on an aligned slab and one off 16-byte
    alignment, all exact; each timed shape's device time at 1, 2, 4 and
    8 segments a row; and kernel H at k = 128 over every fan row (the
    tier's rows in one H launch, W = 2 only), for comparison."""
    from shortseq_torch.ops import pairwise
    from shortseq_torch.umi import dedup

    words, lens_d, gids_d, rows_d = band
    u_pad, block, lo = len(words), BAND_ROWS, BAND_LO
    if slab is None:
        slab = torch.empty((block, u_pad), dtype=torch.int32, device="cuda")
    pairwise.hamming_pairwise_tiled(words[lo:lo + block], words, out=slab)
    sl = slice(lo, lo + block)
    errs, timed = [], []

    def segs_call(s, args, k):
        dedup._EXTRACT_SEGS = s
        try:
            return dedup.neighbor_extract(*args, k)
        finally:
            dedup._EXTRACT_SEGS = 0

    def case(name, args, k):
        got = dedup.neighbor_extract(*args, k)
        want = dedup.neighbor_extract_plain(*args, k)
        errs.append(exact(f"C {name} k={k}", got, want))
        ms, plain_ms = timer([lambda: dedup.neighbor_extract(*args, k),
                              lambda: dedup.neighbor_extract_plain(*args, k)])
        timed.append((name, args, k, int((want[1] > k).sum()), ms, plain_ms,
                      bound(args[:6], want)))

    band_args = (slab, lens_d[sl], gids_d[sl], rows_d[sl], lens_d, gids_d, 3)
    for k in (16, 128):
        case(f"[{block},{u_pad}]", band_args, k)

    fw, fl = fan_words(torch)
    f_u = len(fl)
    f_pad = -(-f_u // 128) * 128
    f_words = torch.zeros((f_pad, 2), dtype=torch.int32, device="cuda")
    f_words[:f_u] = fw
    f_lens = torch.full((f_pad,), -1, dtype=torch.int32, device="cuda")
    f_lens[:f_u] = torch.from_numpy(fl).cuda()
    f_gids = torch.zeros(f_pad, dtype=torch.int32, device="cuda")
    tier_rows = min(f_u, max(dedup._DENSE_ROWS_BATCH,
                             getattr(dedup, "_OVERFLOW_SLAB", 0) // f_pad))
    main = None
    for rows in sorted({256, (5 << 20) // f_pad, tier_rows}):
        now = ", its batch now" if rows == tier_rows else ""
        case(f"[{rows},{f_pad}] threshold 2 (the overflow tier's slab on "
             f"{f_u} fan UMIs{now})",
             (pairwise.hamming_pairwise_tiled(f_words[:rows], f_words),
              f_lens[:rows], f_gids[:rows], rows_d[:rows], f_lens, f_gids, 2),
             128)
        if rows == tier_rows:
            main = timed[-1][4:]

    if extras:
        # Kernel H at the tier's cap over every fan row: what the tier's
        # B + C launches would cost as one H launch (W = 2 only).
        hargs = (f_words[:f_u], f_lens[:f_u], f_gids[:f_u], rows_d[:f_u],
                 f_words, f_lens, f_gids, 2, 128)
        got = dedup.neighbor_lists_fused(*hargs)
        errs.append(exact(f"H [{f_u},{f_pad}] k=128", got,
                          dedup.neighbor_lists_fused_plain(*hargs)))
        h_ms = timer([lambda: dedup.neighbor_lists_fused(*hargs)])[0]
        h_line = (f"H [{f_u},{f_pad}] k=128 threshold 2 (every fan row at the "
                  f"tier's cap, for comparison): {h_ms:.4f} ms; ")

    for name, args, k, over, ms, plain_ms, bnd in timed:
        split = launch_split(torch, lambda: dedup.neighbor_extract(*args, k),
                             ("neighbor_extract",))
        line = (f"C {name} k={k} ({over} rows over k): {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms; {bound_text(bnd)}; {split}")
        if extras:
            line += "; by segments a row: " + "; ".join(
                f"{s}: " + launch_split(
                    torch, lambda s=s: segs_call(s, args, k),
                    ("neighbor_extract",)).rsplit(": ", 1)[-1]
                for s in (1, 2, 4, 8))
        lines.append(line)
    del timed
    if extras:
        lines.append(h_line + launch_split(
            torch, lambda: dedup.neighbor_lists_fused(*hargs),
            ("neighbor_lists", "neighbor_merge")))
    small = [t[:8] for t in band_args[1:4]]
    us = host_us(torch, lambda: dedup.neighbor_extract(
        slab[:8], *small, lens_d, gids_d, 3, 128))
    lines.append(f"C wrapper host time at [8,{u_pad}], k = 128: {us:.1f} us "
                 "a call")

    if extras:
        n = 0
        for u in (1001, 1003, 1004, 7424):
            for k in (1, 16, 128):
                host = c_edge_slab(u, k, seed=u + k)
                t = [torch.from_numpy(x).cuda() for x in host]
                want = dedup.neighbor_extract_plain(*t, 1, k)
                if [int(x) for x in want[1][:4]] != [0, k, k + 5, 2]:
                    raise AssertionError(f"C edge slab U={u} k={k}: rows "
                                         f"{want[1][:4].tolist()}")
                off = torch.empty(host[0].size + 1, dtype=torch.int32,
                                  device="cuda")[1:].view(host[0].shape)
                off.copy_(t[0])
                for s in (0, 1, 3, 8):
                    for dist in (t[0], off):
                        errs.append(exact(
                            f"C edge U={u} k={k} segs={s}",
                            segs_call(s, (dist, *t[1:], 1), k), want))
                        n += 1
        lines.append(f"C: {n} edge cases exact (U = 1001, 1003, 1004, 7424; "
                     "k = 1, 16, 128; 0, 1, 3, 8 segments a row; rows with no "
                     "hit, exactly k, k + 5 ending late, first and last "
                     "column, every column; own columns in every segment; pad "
                     "columns; the slab off 16-byte alignment)")
    return dict(replaces="shortseq_tpu/umi/dedup.py:180",
                max_abs_err=max(errs), ms=main[0], plain_ms=main[1],
                bound_ms=main[2][0], bound_by=main[2][1], library_ms=None)


def load_other(root):
    """Another checkout's shortseq_torch (e.g. the parent commit unpacked
    into build/parent/), imported beside this one as shortseq_torch_other:
    the package's imports of itself are all relative, and its kernels
    build into that checkout's own build directory."""
    import importlib.util

    pkg = Path(root).resolve() / "shortseq_torch"
    spec = importlib.util.spec_from_file_location(
        "shortseq_torch_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def overflow_tier(torch, lines, extras=True, reps=11, other=None):
    """_neighbor_lists on phase umi_scale's 7,400 unique fan UMIs at
    threshold 2 (kernel H, then every row through the overflow tier's B +
    C): its wall by host clock and CUDA events (median of `reps` calls),
    its B and C launches and its host fetches (.cpu() calls) in one call.
    With `extras` the tier is also taken at 256-row batches and at one
    batch of every row; with `other` (a checkout's root, see load_other)
    that checkout's tier too.  All settings run in turns within each
    repeat, each list equal to the first's (with `extras`, and to
    device="cpu"), and with `extras` each setting's B and C device time a
    launch (torch.profiler, after every wall)."""
    import importlib

    import numpy as np

    from shortseq_torch.ops import pairwise
    from shortseq_torch.umi import dedup

    words, lengths = fan_words(torch)
    settings = {"its default batches": (dedup, pairwise, None)}
    if extras:
        settings.update({"256-row batches": (dedup, pairwise, 0),
                         "one batch": (dedup, pairwise, 1 << 40)})
    if other is not None:
        pkg = load_other(other).__name__
        settings[f"the tree at {other}"] = (
            importlib.import_module(pkg + ".umi.dedup"),
            importlib.import_module(pkg + ".ops.pairwise"), None)
    real_cpu = torch.Tensor.cpu
    fetches = [0]

    def counted_cpu(self, *a, **k):
        fetches[0] += 1
        return real_cpu(self, *a, **k)

    def run(mod, budget):
        base = getattr(mod, "_OVERFLOW_SLAB", None)
        if budget is not None:
            mod._OVERFLOW_SLAB = budget
        try:
            return mod._neighbor_lists(words, lengths, 2, device="cuda")
        finally:
            if base is not None:
                mod._OVERFLOW_SLAB = base

    counts, lists = {}, {}
    for name, (mod, pw, budget) in settings.items():
        lists[name] = run(mod, budget)
        b0 = pw.hamming_pairwise_tiled.launches
        c0 = mod.neighbor_extract.launches
        fetches[0] = 0
        torch.Tensor.cpu = counted_cpu
        try:
            run(mod, budget)
        finally:
            torch.Tensor.cpu = real_cpu
        counts[name] = (pw.hamming_pairwise_tiled.launches - b0,
                        mod.neighbor_extract.launches - c0, fetches[0])
    walls = {name: ([], []) for name in settings}
    for _ in range(reps):
        for name, (mod, _, budget) in settings.items():
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            run(mod, budget)
            end.record()
            torch.cuda.synchronize()
            walls[name][0].append((time.perf_counter() - t0) * 1e3)
            walls[name][1].append(start.elapsed_time(end))
    # The plain version on the CPU last: its threads would slow the walls.
    want = dedup._neighbor_lists(words.cpu(), lengths, 2, device="cpu") \
        if extras else next(iter(lists.values()))
    want = csr_rows(want)
    for name, got in lists.items():
        got = csr_rows(got)
        if len(got) != len(want) or not all(
                np.array_equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"overflow tier ({name}) differs")
    for name, (mod, _, budget) in settings.items():
        b, c, f = counts[name]
        host, ev = walls[name]
        line = (f"overflow tier ({name}), _neighbor_lists on {len(words)} fan "
                f"UMIs at threshold 2: wall {statistics.median(host):.3f} ms "
                f"(host clock; quartiles {quartiles(host)}), "
                f"{statistics.median(ev):.3f} ms (CUDA events), {reps} calls "
                f"in turns; B {b} and C {c} launches, {f} .cpu() fetches a "
                "call (kernel H's included); lists equal")
        if extras:
            line += "; " + launch_split(
                torch, lambda mod=mod, budget=budget: run(mod, budget),
                ("pairwise", "neighbor_extract"), runs=1)
        lines.append(line)


def csr_rows(nbrs):
    """The rows of _neighbor_lists' CSR as a list of int64 arrays, after
    checking its form: int64 offsets from 0 to len(indices), one a row and
    never falling, and each row's columns strictly ascending."""
    import numpy as np

    indptr, indices = nbrs.indptr, nbrs.indices
    assert indptr.dtype == indices.dtype == np.int64
    assert len(nbrs) == len(indptr) - 1
    assert indptr[0] == 0 and indptr[-1] == len(indices)
    assert (np.diff(indptr) >= 0).all()
    rows = np.split(indices, indptr[1:-1]) if len(nbrs) else []
    assert all((np.diff(r) > 0).all() for r in rows)
    return rows


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return f"{q[0]:.3f}-{q[2]:.3f}"


def kernel_f(torch, timer, lines, words, rng, extras=True):
    """Kernel F against its plain version at the batch phase's shapes
    ([2M,10] words of 150 nt): static (8, 100) (trim_words: a scalar start
    and length; its bound counts the source lanes the output needs, 0-7
    of 10) and ragged (starts 0-40, lengths 60-150; its bound counts every
    lane and the per-row starts and lengths), each exact and timed by
    CUDA events (both before any torch.profiler run) and torch.profiler,
    with the
    launches one call makes (the wrapper's count, and the profiler's trim
    and fill kernels).  With `extras`, also the edge cases of
    f_edge_cases, exact.  Returns the static case's JSON entry."""
    import numpy as np

    from shortseq_torch import batch

    n = len(words)
    lens = torch.full((n,), 150, dtype=torch.int32, device="cuda")
    starts = torch.from_numpy(
        rng.integers(0, 41, size=n).astype(np.int32)).cuda()
    keep = torch.from_numpy(
        rng.integers(60, 151, size=n).astype(np.int32)).cuda()
    # The static case needs source lanes 8 // 16 .. 8 // 16 + 7 of each
    # row (lanes 0-7 of 10), the ragged one every lane.
    needed = n * min(words.shape[1], 8 // 16 + 7 + 1) * 4
    cases = (("static (8, 100)", batch.trim_words, batch.trim_words_plain,
              (words, lens, 8, 100, 7), [lens], needed),
             ("ragged (starts 0-40, lengths 60-150)", batch.trim_words_ragged,
              batch.trim_words_ragged_plain, (words, lens, starts, keep, 10),
              [words, lens, starts, keep], 0))
    errs, timed = [], []
    for name, fn, plain, args, inputs, nbytes in cases:
        want = plain(*args)
        errs.append(exact(f"F {name} [2M,10]", fn(*args), want))
        bnd = bound(inputs, want, nbytes=nbytes)
        del want
        before = batch.trim_words_ragged.launches
        fn(*args)
        calls = batch.trim_words_ragged.launches - before
        timed.append((calls, bnd, *timer([lambda: fn(*args),
                                          lambda: plain(*args)])))
    for (name, fn, _, args, _, _), (calls, bnd, ms, plain_ms) in zip(
            cases, timed):
        split = launch_split(torch, lambda: fn(*args), ("trim", "fill"))
        lines.append(f"F {name} [2M,10]: {ms:.4f} ms, plain {plain_ms:.4f} "
                     f"ms; {bound_text(bnd)}; {calls} counted launch a call; "
                     f"{split}")
    small = (words[:1024], lens[:1024])
    us = [host_us(torch, lambda fn=fn, a=a: fn(*small, *a))
          for fn, a in ((batch.trim_words, (8, 100, 7)),
                        (batch.trim_words_ragged,
                         (starts[:1024], keep[:1024], 10)))]
    lines.append(f"F wrapper host time at [1024,10]: static {us[0]:.1f} us "
                 f"a call, ragged {us[1]:.1f} us a call")
    if extras:
        n_cases = 0
        for name, got, want in f_edge_cases(torch, rng):
            errs.append(exact(f"F {name}", got, want))
            n_cases += 1
        lines.append(f"F: {n_cases} edge cases exact (N = 1, 1001, 4097, 300 "
                     "at W = 10, 10, 3, 64; starts 0, 15, 16, 17, 32 and past "
                     "the row; length 0; out_w 1, W, W + 2; scalar, ragged and "
                     "mixed; rows off 16-byte alignment)")
    _, bnd, ms, plain_ms = timed[0]
    return dict(source=SOURCE_BATCH, replaces="shortseq_tpu/batch.py:56",
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)


def f_edge_cases(torch, rng):
    """Kernel F's edge cases: (name, kernel output, plain output) for
    random words at N = 1, 1001, 4097, 300 (not multiples of a block's
    rows) and W = 10, 10, 3, 64, each also as a row slice off 16-byte
    alignment; static (start, length) with starts on and beside lane
    edges and past every row, length 0, out_w 1, W and W + 2; ragged
    starts and lengths, and one of them a scalar."""
    import numpy as np

    from shortseq_torch import batch

    for n, w in ((1, 10), (1001, 10), (4097, 3), (300, 64)):
        full = card_lanes(torch, rng, n + 1, w)
        lens = torch.from_numpy(rng.integers(0, 16 * w + 1, size=n + 1)
                                .astype(np.int32)).cuda()
        starts = torch.from_numpy(rng.integers(-3, 16 * w + 8, size=n)
                                  .astype(np.int32)).cuda()
        keep = torch.from_numpy(rng.integers(-2, 16 * w + 8, size=n)
                                .astype(np.int32)).cuda()
        for view, wd, ln in (("", full[:n], lens[:n]),
                             (" off 16 B", full[1:], lens[1:])):
            for out_w in (1, w, w + 2):
                tag = f"[{n},{w}]{view} out_w={out_w}"
                for s, k in ((0, 16 * w), (15, 100), (16, 0), (17, 40),
                             (32, 1000), (16 * w + 3, 5)):
                    yield (f"{tag} ({s}, {k})",
                           batch.trim_words(wd, ln, s, k, out_w),
                           batch.trim_words_plain(wd, ln, s, k, out_w))
                for s, k in ((starts, keep), (17, keep), (starts, 40)):
                    sp = s if isinstance(s, torch.Tensor) else \
                        torch.full_like(keep, s)
                    kp = k if isinstance(k, torch.Tensor) else \
                        torch.full_like(keep, k)
                    yield (f"{tag} ragged",
                           batch.trim_words_ragged(wd, ln, s, k, out_w),
                           batch.trim_words_ragged_plain(wd, ln, sp, kp,
                                                         out_w))


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


#: The largest sort key, kernel I's key of every PAD row.
PAD_KEY = 2**63 - 1


def collision_cases(tile, widths=(7, 10, 64)):
    """Kernel D's collision cases on the hash path, built from its tile's
    row count: (name, words uint32 [N, W], lengths, weights, keys int64
    [N], collision 0 or 1).  The rows are given in sorted order (perm =
    arange(N)) with ascending keys, so each pair sits exactly where its
    name says: across a tile edge, at rows 0 and 1, across a thread's 8
    rows, two rows that differ only in length; and cases that must not
    flag: a live row with the PAD key next to PAD rows (whose stale words
    differ), equal rows sharing a key across a tile edge, distinct keys."""
    import numpy as np

    pad = 2**31 - 1
    rng = np.random.default_rng(12)
    cases = []
    for w in widths:
        def distinct(n):
            words = rng.integers(0, 2**32, size=(n, w),
                                 dtype=np.uint64).astype(np.uint32)
            words[:, 0] = np.arange(n)
            keys = np.arange(n, dtype=np.int64) * 7919 - 2**40
            return words, np.full(n, 150, np.int32), keys

        def add(name, words, lengths, keys, want):
            cases.append((f"{name} W={w}", words, lengths,
                          rng.integers(1, 5, size=len(lengths))
                          .astype(np.int32), keys, want))

        n = 2 * tile + 5
        for name, i in (("pair across a tile edge", tile),
                        ("pair at rows 0 and 1", 1),
                        ("pair across a thread's rows", 8)):
            words, lens, keys = distinct(n)
            keys[i] = keys[i - 1]
            add(name, words, lens, keys, 1)
        words, lens, keys = distinct(n)
        words[101] = words[100]
        lens[101] = 151
        keys[101] = keys[100]
        add("pair differing in length only", words, lens, keys, 1)
        words, lens, keys = distinct(tile + 23)
        lens[tile + 3:] = pad
        keys[tile + 2:] = PAD_KEY
        add("live row with the PAD key, then PAD rows", words, lens, keys, 0)
        sizes = [3, tile + 1, 5]
        words, lens, keys = distinct(len(sizes))
        rows = np.repeat(np.arange(len(sizes)), sizes)
        add("equal rows with one key across a tile edge", words[rows],
            lens[rows], keys[rows], 0)
        add("distinct keys", *distinct(n), 0)
    return cases


def launch_split(torch, fn, tags, runs=3):
    """launch_times as text: each tag's device ms a launch and the
    launches seen in `runs` calls."""
    split = launch_times(torch, fn, tags, runs)
    if not split:
        return "launch split not measured (the profiler saw no device time)"
    return f"device ms a launch (launches seen in {runs} calls): " + \
        ", ".join(f"{k} {ms:.4f} ms x {seen}"
                  for k, (ms, seen) in split.items())


def launch_sequence(torch, fn, tag):
    """Device ms of each launch of fn whose kernel name holds `tag`, in
    the order they ran, from torch.profiler over one call (L2 flushed
    before it); empty when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        flush.add_(1)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return [e.device_time_total / 1000 for e in prof.events()
            if tag in e.name.lower()]


def launch_times(torch, fn, tags, runs=3):
    """{tag: (device ms a launch, launches seen)} of fn's launches whose
    kernel names hold each tag (for D: tile, finish, and the fills of its
    scratch; for H: the lists and the merge), from torch.profiler over
    `runs` calls; empty when the profiler saw no device time.  Every
    tag's time is divided by the launches seen, never by `runs`, so a
    profile that drops a call's events cannot shrink it, and the count
    shows that it did.  The profile idles 50 ms on each side of the
    calls: late in a long process the profiler has dropped the launches
    of a call's first millisecond or so, as if the card's clock had
    drifted from the host's.  L2 is flushed before each call by an add
    over 128 MiB, which no tag matches."""
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
    if not any(split.values()):
        return {}
    return {k: (v / seen[k], seen[k]) for k, v in split.items()}


def kernel_d(torch, timer, rng, lines):
    """Kernel D against its plain version: the edge cases of d_edge_cases
    (exact, not timed), then the timed shapes: random 32-nt-class rows
    (nearly all unique), 150-nt rows drawn Zipf(1.2) from 200,000 keys
    (one group of ~390,000 rows), 96-nt-class rows from a pool, and
    32-nt-class rows that are all one key (the worst skew).  The first
    two shapes also time torch.unique of the (length, row) keys, the one
    PyTorch call for unique_count's grouping at unit weights (the JSON
    line's library_ms: the random rows')."""
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
        pool = card_lanes(torch, rng, m, w)
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
        fns = [
            lambda: cdev.group_count(words, lengths, weights, perm, n),
            lambda: cdev.group_count_plain(words, lengths, weights, perm, n),
            lambda: cdev.sort_rows(words, lengths),
            lambda: cdev.unique_count(words, lengths, weights)]
        library = ""
        if keys is None or zipf:
            # K4's library yardstick: torch.unique groups the (length,
            # row) keys and counts them, unique_count's whole function at
            # unit weights.
            def unique():
                return torch.unique(torch.cat([lengths[:, None], words], 1),
                                    dim=0, return_counts=True)

            keys_u, counts_u = unique()
            if len(counts_u) != groups or \
                    not torch.equal(counts_u.sort().values,
                                    want[2][:groups].long().sort().values):
                raise AssertionError(f"torch.unique [{n},{w}] groups differ "
                                     "from unique_count's")
            del keys_u, counts_u
            fns.append(unique)
        del want
        ms, plain_ms, sort_ms, total_ms, *lib = timer(fns)
        if lib:
            library = f"; torch.unique (the library call) {lib[0]:.4f} ms"
        split = launch_split(
            torch, lambda: cdev.group_count(words, lengths, weights, perm, n),
            ("group_tile", "group_finish", "fill"))
        lines.append(f"D [{n},{w}] ({groups} groups, largest {biggest}): "
                     f"{ms:.4f} ms, plain {plain_ms:.4f} ms; {split}; "
                     f"sort {sort_ms:.4f} ms; unique_count (sort + D) "
                     f"{total_ms:.4f} ms{library}; {bound_text(bnd)}")
        if d_main is None:
            d_main = (ms, plain_ms, bnd, lib[0])
        del words, lengths, weights, perm
    return dict(source=SOURCE_D, replaces="shortseq_tpu/count/device.py:156",
                max_abs_err=max(errs), ms=d_main[0], plain_ms=d_main[1],
                bound_ms=d_main[2][0], bound_by=d_main[2][1],
                library_ms=d_main[3])


def file2_words(torch, rng, n=2_000_000, keys=200_000):
    """File 2's 64-lane bucket on the card: n reads of 150 nt drawn
    Zipf(1.2) from `keys` random ones (lanes past nt 150 zero).  Returns
    (words [n, 64], lengths [n], weights [n] of ones)."""
    pool = card_lanes(torch, rng, keys, 64)
    pool[:, 10:] = 0
    pool[:, 9] &= (1 << 2 * (150 - 144)) - 1
    pick = torch.from_numpy(zipf_pick(rng, keys, n)).cuda()
    words = pool[pick].contiguous()
    del pool
    return (words, torch.full((n,), 150, dtype=torch.int32, device="cuda"),
            torch.ones(n, dtype=torch.int32, device="cuda"))


def kernel_i(torch, timer, rng, lines):
    """Kernel I (the row hash of unique_count's hash path) and kernel D's
    collision check, on the card:
      - I exact against its plain version at [2M,64] (file 2's bucket),
        [2M,10] (PackedBatch's 150-nt rows), [100003,7] with its rows 4
        bytes off 16-byte alignment, each with 1% PAD rows, at seeds 0
        and 7;
      - D with the keys (s_hash) exact against its plain version on
        collision_cases, each collision word as the case says;
      - at [2M,64] Zipf: I by CUDA events and device time beside its
        bound, the hash path's two sorts, D with the keys, the whole
        unique_count, the lex path (sort_rows + D) and torch.unique;
      - a forced collision at [200000,64]: a _row_hash that collides for
        seed 0 only gives the table of the CPU under the same patch, one
        that always collides gives a table every materialization refuses;
      - unique_count on the card against unique_count on the CPU (the
        plain versions, which the CPU tests hold to the JAX package),
        array for array, at [2M,64] Zipf and [100003,7] with PAD rows of
        stale words (after every timing: the CPU work slows later
        launches).
    Returns the JSON line's row_hash entry ([2M,64])."""
    import numpy as np

    from shortseq_torch.count import device as cdev
    from shortseq_torch.ops.lanes import from_numpy_u32

    pad = cdev.PAD_LENGTH
    words, lengths, weights = file2_words(torch, rng)
    n = len(lengths)
    w150 = card_lanes(torch, rng, n, 10)
    w150[:, 9] &= (1 << 2 * (150 - 144)) - 1
    m = 100_003
    off = torch.empty(m * 7 + 1, dtype=torch.int32, device="cuda")[1:] \
        .view(m, 7)
    off.copy_(card_lanes(torch, rng, m, 7))
    if off.data_ptr() % 16 == 0:
        raise AssertionError("the W = 7 rows are not off 16 bytes")
    errs = []
    for name, wd in (("[2M,64]", words), ("[2M,10]", w150),
                     ("[100003,7] off 16 bytes", off)):
        ln = rng.integers(97, 301, size=len(wd)).astype(np.int32)
        ln[rng.random(len(wd)) < 0.01] = pad
        ln = torch.from_numpy(ln).cuda()
        for seed in (0, 7):
            got = cdev._row_hash(wd, ln, seed)
            errs.append(exact(f"I {name} seed {seed}", [got],
                              [cdev._row_hash_plain(wd, ln, seed)]))
            if not bool((got[ln == pad] == PAD_KEY).all()):
                raise AssertionError(f"I {name}: a PAD row's key")
    del w150
    cases = collision_cases(cdev.GROUP_TILE_ROWS)
    for name, wd, ln, wt, keys, want in cases:
        args = [from_numpy_u32(wd).cuda(), torch.from_numpy(ln).cuda(),
                torch.from_numpy(wt).cuda(),
                torch.arange(len(ln), device="cuda")]
        keys = torch.from_numpy(keys).cuda()
        got = cdev.group_count(*args, len(ln), keys)
        exact(f"D with keys, {name}", got,
              cdev.group_count_plain(*args, len(ln), keys))
        if int(got[4]) != want:
            raise AssertionError(f"D with keys, {name}: collision word "
                                 f"{int(got[4])}, want {want}")
    lines.append(f"I: exact at [2M,64], [2M,10] and [100003,7] off 16 "
                 f"bytes, 1% PAD rows, seeds 0 and 7; D with keys: "
                 f"{len(cases)} collision cases exact, each word as wanted")

    keys = cdev._row_hash(words, lengths, 0)
    s_hash, perm = cdev._hash_order(words, lengths, 0)
    groups = int(cdev.group_count(words, lengths, weights, perm, n,
                                  s_hash)[3])

    def unique():
        return torch.unique(torch.cat([lengths[:, None], words], 1), dim=0,
                            return_counts=True)

    t = timer([lambda: cdev._row_hash(words, lengths, 0),
               lambda: cdev._row_hash_plain(words, lengths, 0),
               lambda: hash_sorts_library(keys, lengths),
               lambda: cdev.group_count(words, lengths, weights, perm, n,
                                        s_hash),
               lambda: cdev.unique_count(words, lengths, weights),
               lambda: cdev.group_count(words, lengths, weights,
                                        cdev.sort_rows(words, lengths), n),
               unique], runs=5)
    bnd = bound([words, lengths], [keys])
    split = launch_split(torch, lambda: cdev._row_hash(words, lengths, 0),
                         ("row_hash",))
    d_split = launch_split(
        torch, lambda: cdev.group_count(words, lengths, weights, perm, n,
                                        s_hash),
        ("group_tile", "group_finish", "fill"))
    lines.append(
        f"I [2M,64] Zipf ({groups} groups): {t[0]:.4f} ms, plain "
        f"{t[1]:.4f} ms; {split}; {bound_text(bnd)}. The hash path: I, the "
        f"two sorts {t[2]:.4f} ms, D with keys {t[3]:.4f} ms ({d_split}); "
        f"unique_count {t[4]:.4f} ms; the lex path (sort_rows + D) "
        f"{t[5]:.4f} ms; torch.unique {t[6]:.4f} ms")
    del keys, s_hash, perm

    # A forced collision: seed 0 collides, seed 1 does not.
    sub = [x[:200_000].contiguous() for x in (words, lengths, weights)]
    real = cdev._row_hash
    seeds = []

    def first_seed_collides(wd, ln, seed):
        seeds.append(seed)
        out = real(wd, ln, seed)
        return torch.zeros_like(out) if seed == 0 else out

    cdev._row_hash = first_seed_collides
    try:
        card = cdev.unique_count(*sub)
        cpu = cdev.unique_count(*(x.cpu() for x in sub))
        if seeds != [0, 1, 0, 1]:
            raise AssertionError(f"forced collision: seeds drawn {seeds}")
        exact("unique_count [200000,64], seed 0 colliding",
              [x.cpu() for x in card], cpu)
        cdev._row_hash = lambda wd, ln, seed: torch.zeros(
            len(ln), dtype=torch.int64, device=wd.device)
        try:
            cdev.table_to_host(cdev.unique_count(*sub))
            raise AssertionError("an always-colliding hash gave a table")
        except OverflowError:
            pass
    finally:
        cdev._row_hash = real
    plain = [x.cpu() for x in cdev.unique_count(*sub)]
    if not (torch.equal(plain[3], cpu[3]) and torch.equal(
            plain[2][:int(cpu[3])].sort().values,
            cpu[2][:int(cpu[3])].sort().values)):
        raise AssertionError("forced collision: groups differ from seed 0's")
    lines.append(f"forced collision at [200000,64]: seed 0 colliding, seed 1 "
                 f"drawn, table equal to the CPU's under the same patch "
                 f"({int(cpu[3])} groups); a hash colliding for all "
                 f"{cdev._HASH_MAX_TRIES} seeds: OverflowError")
    del sub

    # The card against the CPU, array for array.
    t0 = time.perf_counter()
    card = cdev.unique_count(words, lengths, weights)
    cpu = cdev.unique_count(words.cpu(), lengths.cpu(), weights.cpu())
    exact("unique_count [2M,64] card vs CPU", [x.cpu() for x in card], cpu)
    ln = rng.integers(97, 113, size=m).astype(np.int32)
    ln[rng.random(m) < 0.1] = pad
    ln = torch.from_numpy(ln).cuda()
    few = torch.from_numpy(rng.integers(0, 50, size=m)).cuda()
    off.copy_(off[:50][few])                   # 50 keys, stale PAD words
    wt = torch.from_numpy(rng.integers(1, 5, size=m).astype(np.int32)).cuda()
    exact("unique_count [100003,7] card vs CPU",
          [x.cpu() for x in cdev.unique_count(off, ln, wt)],
          cdev.unique_count(off.cpu(), ln.cpu(), wt.cpu()))
    lines.append(f"unique_count on the card equal to the CPU's array for "
                 f"array at [2M,64] Zipf ({int(card[3])} groups) and "
                 f"[100003,7] with PAD rows of stale words "
                 f"({time.perf_counter() - t0:.1f} s with the CPU's)")
    return dict(source=SOURCE_D, replaces="shortseq_tpu/count/device.py:62",
                max_abs_err=max(errs), ms=t[0], plain_ms=t[1],
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)


def sort_rows_library(words, lengths):
    """unique_count's row sort before kernel S, kept here as S's library
    yardstick (library_ms); the port never calls it.  The same
    permutation as sort_rows: one stable torch.sort (CUB's radix sort on
    the card) per pair of 32-bit key columns fused into an int64 key,
    least significant pair first, each followed by a gather of the key
    and of the permutation so far."""
    import torch

    digits = [lengths] + [words[:, j] for j in range(words.shape[1])]
    perm = None
    end = len(digits)
    while end > 0:
        lo = digits[end - 1]
        if end >= 2:
            hi = digits[end - 2].to(torch.int32) ^ -2**31
            key = hi.long() * (1 << 32) + (lo.long() & 0xFFFFFFFF)
            end -= 2
        else:
            key = lo.to(torch.int32) ^ -2**31
            end -= 1
        if perm is not None:
            key = key[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def hash_sorts_library(keys, lengths):
    """The hash path's sorts before kernel S (S's library yardstick
    there): a stable torch.sort of the lengths, then of the keys in that
    order.  Returns (s_hash, perm) as _hash_order does."""
    import torch

    by_length = torch.sort(lengths, stable=True).indices
    s_hash, order = torch.sort(keys[by_length], stable=True)
    return s_hash, by_length[order]


def sort_edge_cases(tile, resident=None):
    """Kernel S's exactness cases, built from its tile's row count:
    (name, words uint32 [N, W], lengths int32 [N]).  W <= 6 goes through
    sort_rows, wider rows through _sort_keys.  With `resident` (the
    blocks of S's pass the card holds at once, ssq_sort_resident_blocks)
    also tile counts just below, at and just above it."""
    import numpy as np

    pad = 2**31 - 1
    rng = np.random.default_rng(13)

    def rows(n, w, lens=(15, 32), pad_share=0.0):
        words = rng.integers(0, 2**32, size=(n, w),
                             dtype=np.uint64).astype(np.uint32)
        lengths = rng.integers(lens[0], lens[1] + 1, size=n).astype(np.int32)
        lengths[rng.random(n) < pad_share] = pad
        return words, lengths

    cases = [("N = 1", *rows(1, 2)), ("N = 1, W = 7", *rows(1, 7)),
             ("N = 100 (under a tile)", *rows(100, 2, pad_share=0.1)),
             ("N = 100 (under a tile), W = 7", *rows(100, 7))]
    for n in (tile - 1, tile, tile + 1, 3 * tile + 17):
        cases.append((f"N = {n} (tile {tile})", *rows(n, 2, pad_share=0.1)))
    words, lengths = rows(1, 2)
    n = 3 * tile + 5
    cases.append(("every key equal (every digit skipped)",
                  np.repeat(words, n, 0), np.repeat(lengths, n)))
    cases.append(("every key equal, W = 10 (by_length the identity)",
                  np.repeat(rows(1, 10)[0], n, 0), np.full(n, 150, np.int32)))
    words, lengths = rows(2 * tile + 9, 2)
    cases.append(("all PAD (stale words)", words, np.full_like(lengths, pad)))
    cases.append(("all PAD, W = 7", rows(2 * tile + 9, 7)[0],
                  np.full_like(lengths, pad)))
    words, lengths = rows(2 * tile + 7, 2)
    lengths = rng.choice(np.array([0, 1024, pad], np.int32), size=len(words))
    cases.append(("lengths 0 and 1024 beside PAD", words, lengths))
    words, lengths = rows(3 * tile + 1, 3, (0, 1024), 0.05)
    cases.append(("only the length varies (2 digits), W = 3",
                  np.repeat(words[:1], len(words), 0), lengths))
    words, lengths = rows(3 * tile + 2, 2)
    words = np.repeat(words[:1], len(words), 0)
    words[:, 1] ^= rng.integers(0, 256, size=len(words)).astype(np.uint32) \
        << np.uint32(16)
    cases.append(("a single varying digit (lane 1, bits 16-23)", words,
                  np.full(len(words), 24, np.int32)))
    for w in (1, 3, 5, 6, 7):
        cases.append((f"W = {w}, 5% PAD",
                      *rows(2 * tile + 3, w, (0, 16 * w), 0.05)))
    words, lengths = rows(2 * tile + 11, 2)
    top = rng.random(words.shape) < 0.5
    words = np.where(top, words | 0x80000000, words & 0x7FFFFFFF)
    cases.append(("lanes with bit 31 set or clear", words.astype(np.uint32),
                  lengths))
    for w in (2, 10):
        pool, pool_len = rows(5, w, (16, 17))
        pick = rng.integers(0, 5, size=3 * tile + 11)
        cases.append((f"heavy duplicates, 5 keys, W = {w}", pool[pick],
                      pool_len[pick]))
    for w in (2, 10):
        # Zipf(1.5) over 50 keys: one key holds about 40% of 40 tiles.
        pool, pool_len = rows(50, w, (20, 24))
        pick = np.minimum(rng.zipf(1.5, size=40 * tile) - 1, 49)
        cases.append((f"a Zipf run of one key over 40 tiles, W = {w}",
                      pool[pick], pool_len[pick]))
    for w in (2, 8):
        cases.append((f"live lengths up to 5000 (the full-width length), "
                      f"W = {w}", *rows(2 * tile + 13, w, (0, 5000), 0.1)))
    for tiles in (resident - 1, resident, resident + 1) if resident else ():
        cases.append((f"{tiles} tiles ({resident} blocks resident)",
                      *rows(tiles * tile - 3, 2)))
    return cases


def file1_words(torch, rng, n):
    """n rows of count's file 1 on the card: reads of 15-32 nt as 2
    lanes, every bit past a read's 2 bits a nucleotide zero.  Returns
    (words [n, 2], lengths [n])."""
    import numpy as np

    from shortseq_torch.ops.lanes import from_numpy_u32

    lengths = rng.integers(15, 33, size=n).astype(np.int32)
    words = rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64)
    bits = 2 * lengths.astype(np.uint64)
    one = np.uint64(1)
    words[:, 0] &= (one << np.minimum(bits, 32)) - one
    words[:, 1] &= (one << np.maximum(bits, 32) - np.uint64(32)) - one
    return (from_numpy_u32(words.astype(np.uint32)).cuda(),
            torch.from_numpy(lengths).cuda())


def s_exact(torch, cdev, name, words, lengths):
    """Kernel S against its plain version and the library path on one
    input: the histograms, the pass table and the permutation (W <= 6:
    sort_rows), or the histograms of the lengths and keys, the table, the
    length order (the identity when every row has one length), the
    permutation and the sorted keys (wider rows: _sort_keys of kernel I's
    seed-0 keys as the first hash family and as a later one).  Returns
    (max abs err, S's candidate digits in launch order as (column,
    shift, table mode))."""
    n, w = words.shape
    if w <= cdev._LEX_SORT_MAX_LANES:
        part, keys = cdev._KEY_PATH, None
        run = cdev._sort_launch(words, lengths, None, None, part, n)
        hist = cdev._sort_hist_plain(words, lengths, None)
    else:
        part, w, keys = cdev._HASH_FIRST, 0, cdev._row_hash(words, lengths, 0)
        run = cdev._sort_launch(None, lengths, keys, None, part, n)
        hist = cdev._sort_hist_plain(None, lengths, keys)
    exact(f"S histograms, {name}", [run.hist], [hist])
    exact(f"S pass table, {name}", [run.table.cpu()],
          [cdev._sort_table_plain(hist.cpu(), w, part)])
    passes = s_passes(cdev, run.table.cpu(), w, part)
    if keys is None:
        perm = cdev.sort_rows(words, lengths)
        exact(f"S, {name}, against the library path", [perm],
              [sort_rows_library(words, lengths)])
        return exact(f"S, {name}", [perm],
                     [cdev.sort_rows_plain(words, lengths)]), passes
    s_hash, perm, by = cdev._sort_keys(keys, lengths)
    by_plain = cdev._length_order_plain(lengths)
    exact(f"S length order, {name}", [by.long()],
          [torch.arange(n, device=by.device) if by_plain is None
           else by_plain])
    exact(f"S, {name}, from the length order",
          list(cdev._sort_keys(keys, None, by)[:2]),
          list(cdev._sort_keys_plain(keys, None, by_plain)[:2]))
    exact(f"S, {name}, against the library path", [s_hash, perm],
          list(hash_sorts_library(keys, lengths)))
    return exact(f"S, {name}", [s_hash, perm],
                 list(cdev._sort_keys_plain(keys, lengths)[:2])), passes


def s_passes(cdev, table, w, part):
    """(column, shift, mode) of each candidate digit of one S call, in
    launch order, from its pass table (int32 [candidates, 4] on the
    host)."""
    cands = [c for cols in cdev._sort_columns(w, part)
             for c in cdev._candidates(cols)]
    return [(col, shift, mode)
            for (col, shift), mode in zip(cands, table[:, 0].tolist())]


def pass_bytes(cdev, passes):
    """The pass model's bytes a row of S's varying digits: each reads and
    writes a key, 8 bytes for a lane pair or the hash key, else 4, and a
    4-byte index."""
    return sum(2 * ((8 if col >= cdev._PAIR or col == cdev._HASH_KEY else 4)
                    + 4) for col, _, mode in passes if mode == cdev._PASS)


def s_sequence(torch, cdev, fn, passes):
    """S's launches of one call in order, from torch.profiler: the
    histograms, the plan, then each candidate's pass with its device ms
    (a skipped candidate's launch returns at once).  Returns (text, the
    skipped launches' median device ms or None)."""
    seq = launch_sequence(torch, fn, "sort_")
    if len(seq) != 2 + len(passes):
        return (f"{len(seq)} launches seen, not the 2 + {len(passes)} "
                f"queued (the profiler dropped some)", None)
    names = {cdev._PASS: "", cdev._SKIP: " skipped", cdev._COPY: " copy"}
    skipped = [ms for ms, (_, _, mode) in zip(seq[2:], passes)
               if mode == cdev._SKIP]
    text = (f"hist {seq[0]:.4f}, plan {seq[1]:.4f}; "
            + ", ".join(f"{'L' if col < 0 and col != cdev._HASH_KEY else ''}"
                        f"{shift}{names[mode]} {ms:.4f}"
                        for ms, (col, shift, mode) in zip(seq[2:], passes))
            + f"; {len(passes)} candidate launches, {len(skipped)} skipped, "
            f"device ms in all {sum(seq):.4f}")
    return text, statistics.median(skipped) if skipped else None


def no_host_sync(torch, name, fn):
    """fn under torch.cuda.set_sync_debug_mode("error"): raises if it
    synchronizes with the host (a read back, an .item(), a .cpu())."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        raise AssertionError(f"{name}: a host sync ({e})") from e
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def d_in_order(torch, timer, cdev, lines, shapes):
    """Kernel D on rows already in S's order against D on the same rows
    through S's permutation (D's code unchanged): the rows gathered into
    sorted order once, then group_count with perm = arange; both tables
    equal, with CUDA-event and device times.  The number that decides
    whether S should write the sorted rows for D."""
    for name, words, lengths in shapes:
        n = len(lengths)
        weights = torch.ones(n, dtype=torch.int32, device="cuda")
        perm = cdev.sort_rows(words, lengths)
        s_words, s_len = words[perm].contiguous(), lengths[perm].contiguous()
        ident = torch.arange(n, device="cuda")
        fns = [lambda: cdev.group_count(words, lengths, weights, perm, n),
               lambda: cdev.group_count(s_words, s_len, weights, ident, n)]
        exact(f"D on in-order rows, {name}", fns[1](), fns[0]())
        t = timer(fns)
        splits = [launch_split(torch, fn, ("group_tile", "group_finish"))
                  for fn in fns]
        lines.append(f"D {name} through S's perm: {t[0]:.4f} ms ({splits[0]}"
                     f"); on the same rows in sorted order (perm = arange): "
                     f"{t[1]:.4f} ms ({splits[1]})")
        del weights, perm, s_words, s_len, ident


def no_library_sort(torch):
    """A context in which torch.sort and torch.argsort (functions and
    methods) raise: unique_count on the card must not reach them."""
    import contextlib

    @contextlib.contextmanager
    def stubbed():
        def refuse(*args, **kwargs):
            raise AssertionError("torch.sort called on unique_count's path")

        names = ("sort", "argsort")
        funcs = {k: getattr(torch, k) for k in names}
        methods = {k: torch.Tensor.__dict__.get(k) for k in names}
        for k in names:
            setattr(torch, k, refuse)
            setattr(torch.Tensor, k, refuse)
        try:
            yield
        finally:
            for k in names:
                setattr(torch, k, funcs[k])
                if methods[k] is None:
                    delattr(torch.Tensor, k)
                else:
                    setattr(torch.Tensor, k, methods[k])

    return stubbed()


def kernel_s(torch, timer, rng, lines):
    """Kernel S (unique_count's row sort) against its plain version on
    the card:
      - the histograms, the pass table and the permutation (and on the
        hash path the length order and the sorted keys) exact against the
        plain versions and the library path on sort_edge_cases, with the
        tile counts around the card's resident blocks;
      - at the main path's shapes: file 1's words [10M,2] (the JSON line),
        one of its 8 shards [1.25M,2], [1M,6] from a 300,000-row pool,
        and on the hash path file 2's bucket [2M,64] Zipf and [2M,10]
        (150-nt rows): exact, the varying and skipped candidates, S's
        CUDA-event and device times (each launch in order, the empty
        launch's cost) beside its bound and the pass model, the plain
        version's and the library path's times, and unique_count with S
        and with the library path's sort, in turns;
      - sort_rows and _sort_keys at [10M,2] and [2M,64], and unique_count
        at [10M,2], under torch.cuda.set_sync_debug_mode("error"): no host
        sync;
      - D on rows in S's order against D through S's perm (d_in_order) at
        [10M,2] and [1.25M,2];
      - unique_count with torch.sort and torch.argsort stubbed to raise,
        at every shape, equal to unique_count on the CPU array for array
        (after every timing: the CPU work slows later launches).
    Returns the JSON line's row_sort entry ([10M,2])."""
    import numpy as np

    from shortseq_torch import _build
    from shortseq_torch.count import device as cdev
    from shortseq_torch.ops.lanes import from_numpy_u32

    lib = _build.cuda_lib()
    resident = [lib.ssq_sort_resident_blocks(wide) for wide in (0, 1)]
    errs = []
    cases = sort_edge_cases(cdev.SORT_TILE_ROWS, resident[1])
    for name, words, lens in cases:
        errs.append(s_exact(torch, cdev, name, from_numpy_u32(words).cuda(),
                            torch.from_numpy(lens).cuda())[0])
    torch.cuda.synchronize()
    lines.append(f"S: {len(cases)} edge cases exact against the plain "
                 f"versions and the library path (tile "
                 f"{cdev.SORT_TILE_ROWS} rows), histograms and pass tables "
                 f"included; pass blocks resident: {resident[0]} with 4-byte "
                 f"keys, {resident[1]} with 8-byte keys")

    w1, l1 = file1_words(torch, rng, 10_000_000)
    pool = card_lanes(torch, rng, 300_000, 6)
    pool_len = torch.from_numpy(rng.integers(33, 97, size=300_000)
                                .astype(np.int32)).cuda()
    pick = torch.from_numpy(rng.integers(0, 300_000, size=1_000_000)).cuda()
    w6, l6 = pool[pick].contiguous(), pool_len[pick]
    del pool, pool_len, pick
    w64, l64, _ = file2_words(torch, rng)
    w10 = card_lanes(torch, rng, 2_000_000, 10)
    w10[:, 9] &= (1 << 2 * (150 - 144)) - 1
    l10 = torch.full((2_000_000,), 150, dtype=torch.int32, device="cuda")
    shard = 1_250_000
    shapes = [("[10M,2] file 1", w1, l1),
              ("[1.25M,2] one of file 1's 8 shards", w1[:shard], l1[:shard]),
              ("[1M,6]", w6, l6), ("[2M,64] Zipf, hash path", w64, l64),
              ("[2M,10], hash path", w10, l10)]
    main, empty = None, []
    for name, words, lengths in shapes:
        n, w = words.shape
        weights = torch.ones(n, dtype=torch.int32, device="cuda")
        err, passes = s_exact(torch, cdev, name, words, lengths)
        errs.append(err)
        row_bytes = pass_bytes(cdev, passes)
        if w <= cdev._LEX_SORT_MAX_LANES:
            def s_fn():
                return cdev.sort_rows(words, lengths)

            def plain():
                return cdev.sort_rows_plain(words, lengths)

            def library():
                return sort_rows_library(words, lengths)

            bnd = bound([words, lengths], [s_fn()])
        else:
            keys = cdev._row_hash(words, lengths, 0)

            def s_fn():
                return cdev._sort_keys(keys, lengths)[:2]

            def plain():
                return cdev._sort_keys_plain(keys, lengths)[:2]

            def library():
                return hash_sorts_library(keys, lengths)

            bnd = bound([keys, lengths], list(s_fn()))

        def unique_library():
            # unique_count's steps with the library path's sort: on the
            # hash path D takes the keys and the collision word is read.
            if w <= cdev._LEX_SORT_MAX_LANES:
                return cdev.group_count(words, lengths, weights,
                                        sort_rows_library(words, lengths), n)
            s_hash, perm = hash_sorts_library(
                cdev._row_hash(words, lengths, 0), lengths)
            table = cdev.group_count(words, lengths, weights, perm, n, s_hash)
            if int(table[4]):
                raise AssertionError(f"{name}: seed 0 collides")
            return table

        t = timer([s_fn, library, plain,
                   lambda: cdev.unique_count(words, lengths, weights),
                   unique_library], runs=5)
        split = launch_split(torch, s_fn,
                             ("sort_hist", "sort_plan", "sort_pass"))
        model = row_bytes * n / HBM_BYTES_PER_S * 1e3
        seq, skip_ms = s_sequence(torch, cdev, s_fn, passes)
        if skip_ms is not None:
            empty.append(skip_ms)
        varying = sum(mode == cdev._PASS for *_, mode in passes)
        lines.append(
            f"S {name}: {t[0]:.4f} ms, {varying} digit passes of "
            f"{len(passes)} candidates; library path {t[1]:.4f} ms; plain "
            f"{t[2]:.4f} ms; {split}; {bound_text(bnd)}, pass "
            f"model {model:.4f} ms ({row_bytes} B a row); unique_count with "
            f"S {t[3]:.4f} ms, with the library path's sort {t[4]:.4f} ms")
        lines.append(f"S {name}, device ms of each launch in order: {seq}")
        if main is None:
            main = (t, bnd)
            # A copy of one carrying pass's bytes (a key and an index a
            # row in, the same out): the rate a pass could reach.
            src = torch.empty(2 * n, dtype=torch.int32, device="cuda")
            dst = torch.empty_like(src)
            copy_ms = timer([lambda: dst.copy_(src)])[0]
            del src, dst
            lines.append(f"S {name}: a copy of one 32-bit carrying pass's "
                         f"bytes ({16 * n >> 20} MiB moved) {copy_ms:.4f} ms")
        del weights
    lines.append("S: an empty (skipped) pass launch's device ms, median "
                 "at each shape with one: "
                 + (", ".join(f"{ms:.4f}" for ms in empty) or "none seen"))

    # No host sync inside S, nor in unique_count's key path.
    keys64 = cdev._row_hash(w64, l64, 0)
    checks = {"sort_rows [10M,2]": lambda: cdev.sort_rows(w1, l1),
              "_sort_keys [2M,64], first family":
                  lambda: cdev._sort_keys(keys64, l64),
              "_sort_keys [2M,64], a later family": lambda: cdev._sort_keys(
                  keys64, None, cdev._sort_keys(keys64, l64)[2]),
              "sort_rows [2M,64]": lambda: cdev.sort_rows(w64, l64),
              "unique_count [10M,2]": lambda: cdev.unique_count(
                  w1, l1, torch.ones(len(l1), dtype=torch.int32,
                                     device="cuda"))}
    for name, fn in checks.items():
        no_host_sync(torch, name, fn)
    del keys64
    lines.append("S: no host sync under torch.cuda.set_sync_debug_mode("
                 "'error') in " + ", ".join(checks))

    d_in_order(torch, timer, cdev, lines, shapes[:2])

    # The main path without the library sort, then the CPU's tables.
    before = cdev.sort_rows.launches
    cards = []
    with no_library_sort(torch):
        for name, words, lengths in shapes:
            weights = torch.ones(len(lengths), dtype=torch.int32,
                                 device="cuda")
            cards.append([x.cpu() for x in
                          cdev.unique_count(words, lengths, weights)])
    if cdev.sort_rows.launches == before:
        raise AssertionError("unique_count did not launch kernel S")
    t0 = time.perf_counter()
    for (name, words, lengths), card in zip(shapes, cards):
        ones = torch.ones(len(lengths), dtype=torch.int32)
        exact(f"unique_count {name}, card (no torch.sort) vs CPU", card,
              cdev.unique_count(words.cpu(), lengths.cpu(), ones))
    lines.append(f"unique_count with torch.sort and torch.argsort stubbed "
                 f"to raise: S launched {cdev.sort_rows.launches - before} "
                 f"times, each table equal to the CPU's array for array at "
                 + ", ".join(name for name, *_ in shapes)
                 + f" ({time.perf_counter() - t0:.1f} s of CPU)")
    t, bnd = main
    return dict(source=SOURCE_SORT,
                replaces="shortseq_tpu/count/device.py:57",
                max_abs_err=max(errs), ms=t[0], plain_ms=t[2],
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=t[1])


def batch_kernels(torch, timer, rng, lines, extras=True):
    """Kernel A's pack-only mode, E, F (kernel_f; `extras`: its edge
    cases) and G against their plain versions at the batch
    phase's shapes (2M rows of 150 nt: 40 byte lanes, 10 packed lanes),
    each with its device time, G also at 64 lanes, and the one-hot
    pairwise product against kernel B at the calibration shape."""
    import numpy as np

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
    split = launch_split(torch, lambda: bitpack.pack_words_u32(x), ("pack",))
    errs = [err]
    for w4 in (4, 12, 20, 36, 40):   # w = 1, 3, 5, 9, 10 words
        xs = x[:100_003, :w4].contiguous()
        errs.append(exact(f"A pack-only [100003,{w4}]",
                          [bitpack.pack_words_u32(xs)],
                          [bitpack.pack_words_plain(xs)]))
    lines.append(f"A pack-only [2M,40]: {t[0]:.4f} ms, plain {t[1]:.4f} ms; "
                 f"{split}; {bound_text(bnd)}; exact at w = 1, 3, 5, 9 and "
                 "10 words of 100,003 rows (ragged N * w % 4)")
    entry("pack_words", SOURCE, "shortseq_tpu/ops/bitpack.py:116", errs, t,
          bnd)

    del x
    want = bitpack.unpack_ascii_plain(words)
    err = exact("E [2M,10]", [bitpack.unpack_ascii(words)], [want])
    t = timer([lambda: bitpack.unpack_ascii(words),
               lambda: bitpack.unpack_ascii_plain(words)])
    bnd = bound([words], [want])
    del want
    split = launch_split(torch, lambda: bitpack.unpack_ascii(words),
                         ("unpack",))
    lines.append(f"E [2M,10]: {t[0]:.4f} ms, plain {t[1]:.4f} ms; {split}; "
                 + bound_text(bnd))
    entry("unpack_ascii", SOURCE_BATCH, "shortseq_tpu/ops/bitpack.py:148",
          [err], t, bnd)

    out["trim_words"] = kernel_f(torch, timer, lines, words, rng, extras)
    out["hamming_rows"] = kernel_g(torch, timer, lines, words, rng, extras)
    del words

    for w in (1, 2, 10, 64):
        a = card_lanes(torch, rng, 512, w)
        b = card_lanes(torch, rng, 16384, w)
        b[:512] = a ^ (1 << 2 * (w % 16))         # near-identical rows
        exact(f"onehot W={w}", [hamming.hamming_pairwise_onehot(a, b)],
              [pairwise.hamming_pairwise_tiled(a, b)])
        t = timer([lambda: hamming.hamming_pairwise_onehot(a, b),
                   lambda: pairwise.hamming_pairwise_tiled(a, b)])
        lines.append(f"onehot [512]x[16384] W={w}: {t[0]:.4f} ms, kernel B "
                     f"{t[1]:.4f} ms (equal)")
    return out


def card_lanes(torch, rng, n, w):
    """[n, w] random int32 lanes on the card."""
    import numpy as np

    return torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, w),
                                         dtype=np.int64)
                            .astype(np.int32)).cuda()


def kernel_g(torch, timer, lines, words, rng, extras=True, other=None):
    """Kernel G against its plain version: the batch phase's [2M,10] words
    against the same rows rolled by one (the JSON line), random
    [262144,64] (1024-nt rows) and random [2M,1]; each exact, timed by
    CUDA events (every version in turns, before any torch.profiler run)
    and by torch.profiler, beside its bound and the device time of one
    torch.bitwise_xor over the same operands (a yardstick of the card's
    streaming rate); then the wrapper's host time a call at [1024,10], and
    its two operand checks' alone.  With
    `extras`, also the edge cases of g_edge_cases, exact.  `other` (a
    checkout's root, see load_other): that tree's G timed in turns with
    this one's on the same inputs.  Returns the [2M,10] case's entry."""
    import importlib

    from shortseq_torch import _build
    from shortseq_torch.ops import hamming

    versions = {"": hamming}
    if other is not None:
        versions[f"the tree at {other}"] = importlib.import_module(
            load_other(other).__name__ + ".ops.hamming")
    shapes = (("[2M,10]", words, words.roll(1, 0)),
              ("[262144,64]", *(card_lanes(torch, rng, 262144, 64)
                                for _ in range(2))),
              ("[2M,1]", *(card_lanes(torch, rng, 2_000_000, 1)
                           for _ in range(2))))
    errs, timed = [], []
    for name, a, b in shapes:
        want = hamming.hamming_rows_plain(a, b)
        for tag, mod in versions.items():
            errs.append(exact(f"G {name} {tag}",
                              [mod.hamming_rows(a, b)], [want]))
        bnd = bound([a, b], [want], popc=a.shape[0] * -(-a.shape[1] // 2))
        del want
        before = hamming.hamming_rows.launches
        hamming.hamming_rows(a, b)
        calls = hamming.hamming_rows.launches - before
        timed.append((calls, bnd, timer(
            [lambda mod=mod: mod.hamming_rows(a, b)
             for mod in versions.values()]
            + [lambda: hamming.hamming_rows_plain(a, b)])))
    for (name, a, b), (calls, bnd, t) in zip(shapes, timed):
        for (tag, mod), ms in zip(versions.items(), t):
            split = launch_split(torch, lambda: mod.hamming_rows(a, b),
                                 ("hamming_rows",), runs=10)
            lines.append(f"G {name}{' ' + tag if tag else ''}: {ms:.4f} ms, "
                         f"plain {t[-1]:.4f} ms; {split}; {bound_text(bnd)}"
                         + ("" if tag else f"; {calls} counted launch a call"))
        # A yardstick of the card's streaming rate for a like mix of
        # reads and writes: one elementwise torch op over both operands.
        xor = bound([a, b], [a])
        lines.append(f"G {name} yardstick, torch.bitwise_xor(a, b) (reads "
                     f"both, writes [N, W]): {bound_text(xor)}; "
                     + launch_split(torch, lambda: torch.bitwise_xor(a, b),
                                    ("xor",), runs=10))
    a, b = shapes[0][1][:1024], shapes[0][2][:1024]
    for tag, mod in versions.items():
        us = host_us(torch, lambda: mod.hamming_rows(a, b))
        lines.append(f"G wrapper host time at [1024,10]"
                     f"{' ' + tag if tag else ''}: {us:.1f} us a call")
    us = host_us(torch, lambda: (
        _build.check_operand(a, "a", torch.int32, 2, a.device),
        _build.check_operand(b, "b", torch.int32, 2, a.device)))
    lines.append(f"G's two operand checks alone: {us:.1f} us a call")
    if extras:
        n_cases = 0
        for name, got, want in g_edge_cases(torch, rng):
            errs.append(exact(f"G {name}", [got], [want]))
            n_cases += 1
        lines.append(f"G: {n_cases} edge cases exact (N = 1, 3, 4, 5, 4097 "
                     "and a block's rows +- 1 at W = 1, 2, 3, 4, 5, 10, 16, "
                     "33, 63, 64; random, row views 1 row off the base (both "
                     "operands, one), identical rows (0), every code XOR 3 "
                     "(16 W))")
    calls, bnd, t = timed[0]
    return dict(source=SOURCE_BATCH, replaces="shortseq_tpu/ops/hamming.py:26",
                max_abs_err=max(errs), ms=t[0], plain_ms=t[-1],
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)


def g_edge_cases(torch, rng):
    """Kernel G's edge cases: (name, kernel output, plain output) for
    random lanes at N = 1, 3, 4, 5, 4097 and a block's rows +- 1 (the
    kernel's own ssq_hamming_block_rows), W = 1, 2, 3, 4, 5, 10, 16, 33,
    63, 64: the rows as they are, both operands 1 row off the base (4 W
    bytes: off 16-byte alignment unless 4 divides W, so the kernel's
    4-byte instance runs), one operand off, identical rows (all 0) and
    every 2-bit code XOR 0b11 (all 16 W)."""
    from shortseq_torch import _build
    from shortseq_torch.ops import hamming

    lib = _build.cuda_lib()
    for w in (1, 2, 3, 4, 5, 10, 16, 33, 63, 64):
        rows = lib.ssq_hamming_block_rows(w)
        for n in sorted({1, 3, 4, 5, 4097, rows - 1, rows + 1}):
            a, b = (card_lanes(torch, rng, n + 1, w) for _ in range(2))
            tag = f"[{n},{w}]"
            for view, x, y in (("", a[:n], b[:n]), (" both off", a[1:], b[1:]),
                               (" one off", a[1:], b[:n])):
                yield (tag + view, hamming.hamming_rows(x, y),
                       hamming.hamming_rows_plain(x, y))
            for view, y, d in ((" identical", a[:n].clone(), 0),
                               (" codes XOR 3", ~a[:n], 16 * w)):
                want = hamming.hamming_rows_plain(a[:n], y)
                if not bool((want == d).all()):
                    raise AssertionError(f"G {tag}{view}: plain is not {d}")
                yield tag + view, hamming.hamming_rows(a[:n], y), want


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


def k10_edge_cases():
    """K10's exactness cases from its plan's tile rows at each width:
    (name, words uint32 [N, W], lengths, D, cap or None for capacity
    factor 2).  Every third row is PAD unless the case says otherwise.
    They cross tile and look-back edges (N = tile - 1, tile, tile + 1,
    20 tiles), both sides of the one-pass bucket limit (D = 1024, 1025),
    each way a row's hash is folded (W = 1, 2, 5, 6, 64, 128, 256: one
    piece, shuffles, shared atomics, pieces over a warp), a bucket at its
    capacity and one row over, N = 1 and N = 0."""
    import numpy as np

    from shortseq_torch.dist import count as dc

    def tile(w):
        return dc.k10_plan(1, w, 1, 16).tile_rows

    def rows(seed, n, w):
        rng = np.random.default_rng(seed)
        words = rng.integers(0, 2**32, size=(n, w), dtype=np.uint64) \
            .astype(np.uint32)
        lengths = rng.integers(0, 16 * w + 1, size=n).astype(np.int32)
        lengths[::3] = 2**31 - 1
        return words, lengths

    t2, t5, t64 = tile(2), tile(5), tile(64)
    cases = [(f"D={d} N={n} W={w}", *rows(n + d + w, n, w), d, None)
             for d, n, w in ((1, t2 - 1, 2), (2, t2, 2), (3, t2 + 1, 2),
                             (2, 20 * t2 + 11, 2), (6, 3 * t5 + 5, 5),
                             (8, 4 * t64, 64), (8, t64 + 1, 64),
                             (3, 37, 1), (5, 2 * tile(6) + 1, 6),
                             (4, 3 * tile(128) + 2, 128),
                             (4, 2 * tile(256) + 3, 256),
                             (1024, 3 * t2 + 7, 2), (1025, 3 * t2 + 7, 2),
                             (65536, 2 * t2 + 7, 2))]
    keys = one_bucket_keys(0, 3 * t2 // 2, 6)
    lengths = np.full(len(keys), 20, np.int32)
    cases += [("D=6 all rows in bucket 0, cap = rows", keys, lengths, 6,
               len(keys)),
              ("D=6 all rows in bucket 0, cap = rows - 1", keys, lengths, 6,
               len(keys) - 1)]
    one = np.array([[7, 9]], np.uint32)
    cases += [("N = 1, D = 1", one, np.array([5], np.int32), 1, 1),
              ("N = 1, D = 5", one, np.array([5], np.int32), 5, 1),
              ("N = 1, PAD", one, np.array([2**31 - 1], np.int32), 3, 1)]
    cases.append(("N = 0", np.zeros((0, 2), np.uint32),
                  np.zeros(0, np.int32), 4, 0))
    return cases


K10_TAGS = ("bucket_tile", "bucket_fill", "bucket_hash", "bucket_scan",
            "bucket_scatter", "memset (device)", "fillfunctor")


def k10_edges(torch, lines):
    """k10_edge_cases, then pre-deduped tables (PAD rows after the live
    ones, as tier 2 hands them over), a grown three-launch tile, and rows
    off 16-byte alignment; all exact against the plain version, not
    timed.  Returns the max abs errors."""
    from shortseq_torch.count.device import unique_count
    from shortseq_torch.dist import count as dc
    from shortseq_torch.ops.lanes import from_numpy_u32

    def check(name, words, lengths, weights, d, cap):
        got = dc.bucket_send_buffers(words, lengths, weights, d, cap)
        want = dc.bucket_send_buffers_plain(words, lengths, weights, d, cap)
        return exact(f"K10 {name}", got, want), want

    errs, plans = [], set()
    cases = k10_edge_cases()
    for name, words, lengths, d, cap in cases:
        n = len(lengths)
        w = from_numpy_u32(words).cuda()
        ln = torch.from_numpy(lengths).cuda()
        wt = torch.arange(n, dtype=torch.int32, device="cuda") % 7 + 1
        cap = dc.bucket_capacity(n, d, 2.0) if cap is None else cap
        err, want = check(name, w, ln, wt, d, cap)
        errs.append(err)
        if n:
            plans.add(dc.k10_plan(n, w.shape[1], d, 16).one_pass)
        if "cap = rows - 1" in name and not int(want[3]):
            raise AssertionError("K10: the capacity edge did not overflow")
    if plans != {True, False}:
        raise AssertionError(f"K10 edge cases took one plan only: {plans}")
    # Tier 2's input: unique_count's table of duplicate-heavy rows.
    gen = torch.Generator(device="cuda").manual_seed(6)
    for w, n in ((2, 5 * dc.k10_plan(1, 2, 1, 16).tile_rows + 9),
                 (64, 9 * dc.k10_plan(1, 64, 1, 16).tile_rows + 5)):
        pool = torch.randint(-2**31, 2**31 - 1, (n // 4, w), dtype=torch.int32,
                             device="cuda", generator=gen)
        pick = torch.randint(0, n // 4, (n,), device="cuda", generator=gen)
        ln = torch.full((n,), 16 * w, dtype=torch.int32, device="cuda")
        u_w, u_l, u_c, _ = unique_count(pool[pick].contiguous(), ln,
                                        torch.ones_like(ln))
        for d, factor in ((1, 0.25), (1, 2.0), (3, 2.0)):
            errs.append(check(f"pre-deduped [{n},{w}] D={d} factor {factor}",
                              u_w, u_l, u_c, d,
                              dc.bucket_capacity(n, d, factor))[0])
    saved = dc._HISTOGRAM_INTS
    dc._HISTOGRAM_INTS = 64   # D x tiles > 64: three launches, grown tiles
    try:
        w = from_numpy_u32(cases[3][1]).cuda()     # 20 tiles of W = 2
        ln = torch.from_numpy(cases[3][2]).cuda()
        wt = torch.ones(len(ln), dtype=torch.int32, device="cuda")
        for d in (17, 40):
            plan = dc.k10_plan(len(ln), w.shape[1], d, 16)
            if plan.one_pass or plan.tile_rows == dc.BUCKET_TILE_ROWS:
                raise AssertionError(f"K10: budget 64 gave {plan}")
            errs.append(check(f"grown tile D={d}", w, ln, wt, d,
                              dc.bucket_capacity(len(ln), d, 2.0))[0])
    finally:
        dc._HISTOGRAM_INTS = saved
    # Rows 4 or 8 bytes past a 16-byte boundary: narrower pieces.
    for w, shift, n in ((4, 1, 3001), (2, 1, 5001), (64, 2, 700)):
        flat = torch.randint(-2**31, 2**31 - 1, (w * n + shift,),
                             dtype=torch.int32, device="cuda", generator=gen)
        ln = torch.randint(0, 16 * w + 1, (n,), dtype=torch.int32,
                           device="cuda", generator=gen)
        ln[::4] = 2**31 - 1
        wt = torch.ones(n, dtype=torch.int32, device="cuda")
        words = flat[shift:].view(n, w)
        errs.append(check(f"W={w} at a {4 * shift}-byte offset", words, ln,
                          wt, 3, dc.bucket_capacity(n, 3, 2.0))[0])
    lines.append(f"K10: {len(cases) + 11} edge cases exact (tiles of "
                 f"{dc.k10_plan(1, 2, 1, 16).tile_rows} rows at W = 2, "
                 f"{dc.k10_plan(1, 64, 1, 16).tile_rows} at W = 64; D = 1024 "
                 "and 1025; both plans; pre-deduped tables; one bucket at the "
                 "capacity edge; N = 1, 0; a grown tile; rows off 16-byte "
                 "alignment)")
    return errs


def kernel_k10(torch, timer, lines, shapes, main, edges=True):
    """K10 (bucket ids + send buffers) against its plain version: with
    `edges`, k10_edges (exact, not timed), then each (name, words,
    lengths, weights, [(D, capacity factor)]) of `shapes`, exact and timed
    (CUDA events and torch.profiler).  `main` is the (name, D, factor)
    whose times go in the JSON line; no single PyTorch call computes this
    function (library_ms null)."""
    from shortseq_torch.dist import count as dc

    errs = k10_edges(torch, lines) if edges else []
    small = [t[:1024] for t in shapes[0][1:4]]
    us = host_us(torch, lambda: dc.bucket_send_buffers(*small, 1, 1024))
    lines.append(f"K10 wrapper host time at [1024,W] of the first shape, "
                 f"D = 1: {us:.1f} us a call")
    got_main = None
    for name, words, lengths, weights, runs in shapes:
        n = words.shape[0]
        for d, factor in runs:
            cap = dc.bucket_capacity(n, d, factor)
            got = dc.bucket_send_buffers(words, lengths, weights, d, cap)
            want = dc.bucket_send_buffers_plain(words, lengths, weights, d,
                                                cap)
            errs.append(exact(f"K10 {name} D={d} factor {factor}", got, want))
            # A PAD row is never sent: only live rows' words are needed.
            live = int(lengths.ne(2**31 - 1).sum())
            bnd = bound([lengths, weights], want,
                        nbytes=live * words.shape[1] * 4)
            loads = int(want[1].ne(2**31 - 1).sum())
            over = int(want[3])
            del got, want
            ms, plain_ms = timer([
                lambda: dc.bucket_send_buffers(words, lengths, weights, d,
                                               cap),
                lambda: dc.bucket_send_buffers_plain(words, lengths, weights,
                                                     d, cap)])
            split = launch_split(
                torch, lambda: dc.bucket_send_buffers(words, lengths,
                                                      weights, d, cap),
                K10_TAGS)
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


def k10_synthetic(torch, rng):
    """K10's main-path shapes on random words made on the card: file
    1-like [10M,2] (lengths 15-32, nearly all distinct) and file 2-like
    [2M,64] (150-nt keys in the 64-lane bucket, Zipf(1.2) from 200,000),
    each raw and pre-deduped as tier 2 leaves it, at the (D, factor) of
    phase sharded's timed cases."""
    from shortseq_torch.count.device import unique_count

    gen = torch.Generator(device="cuda").manual_seed(8)
    n1, n2 = 10_000_000, 2_000_000
    w1 = torch.randint(-2**31, 2**31 - 1, (n1, 2), dtype=torch.int32,
                       device="cuda", generator=gen)
    l1 = torch.randint(15, 33, (n1,), dtype=torch.int32, device="cuda",
                       generator=gen)
    pool = torch.zeros((200_000, 64), dtype=torch.int32, device="cuda")
    pool[:, :10] = torch.randint(-2**31, 2**31 - 1, (200_000, 10),
                                 dtype=torch.int32, device="cuda",
                                 generator=gen)
    pool[:, 9] &= 0x3FFFFF
    w2 = pool[torch.from_numpy(zipf_pick(rng, 200_000, n2)).cuda()]
    del pool
    l2 = torch.full((n2,), 150, dtype=torch.int32, device="cuda")
    shapes = []
    for name, w, ln, wide in (("[10M,2]", w1, l1, (1, 2, 8, 65536)),
                              ("[2M,64]", w2, l2, (8,))):
        ones = torch.ones(len(ln), dtype=torch.int32, device="cuda")
        shapes.append((name, w, ln, ones,
                       [(1, 0.25)] + [(d, 2.0) for d in wide]))
        shapes.append((f"{name} pre-deduped", *unique_count(w, ln, ones)[:3],
                       [(1, 0.25)]))
    return shapes


def a_and_k10(edges=True):
    """Kernels A and K10 alone, on the card (about a minute with the
    build): `python3 -c "import chip_smoke as cs; cs.a_and_k10()"` from a
    checkout's root.  A at kernel_a's shapes, batch_kernels (A's pack-only
    mode at [2M,40], E, F, G), K10 at k10_synthetic's (with `edges`, its
    exact edge cases first); each line is printed.  Other
    checkouts' packages time the same cases when this file is copied to
    their root, as long as they have the same wrappers."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    timer, lines = Timer(torch), []
    with SmiSampler() as smi:
        kernel_a(torch, timer, lines)
        batch_kernels(torch, timer, np.random.default_rng(0), lines, edges)
        kernel_k10(torch, timer, lines,
                   k10_synthetic(torch, np.random.default_rng(9)),
                   ("[10M,2]", 1, 2.0), edges)
    for line in lines:
        print("  " + line, flush=True)
    print("  during the timings: " + smi.summary(), flush=True)


def c_and_f(edges=True, other=None):
    """Kernels C and F alone, on the card (about a minute with the
    build): `python3 -c "import chip_smoke as cs; cs.c_and_f()"` from a
    checkout's root.  The overflow tier as a whole (overflow_tier, timed
    before any torch.profiler run), C at kernel_c's shapes, then
    batch_kernels (A's pack-only mode, E, F and G at [2M,10], each with
    its device time); with `edges`, C's and F's edge cases, C's segment
    counts and the tier at other batch rows.  The host time of one small
    torch op is taken before anything, after the tier and at the end.
    Each line is printed.  Another checkout's package (e.g. the
    parent commit unpacked by `git archive` into build/parent/) times the
    same cases when this file is copied to its root and run with
    edges=False; `other` (such a checkout's root) also runs that tree's
    overflow tier in turns with this one's, in this process."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    timer, lines = Timer(torch), []
    rng = np.random.default_rng(0)
    x = torch.zeros(1, device="cuda")
    probe = [host_us(torch, lambda: x.add_(1), 2000)]
    with SmiSampler() as smi:
        overflow_tier(torch, lines, edges, other=other)
        probe.append(host_us(torch, lambda: x.add_(1), 2000))
        kernel_c(torch, timer, lines, umi_band(torch, rng), extras=edges)
        batch_kernels(torch, timer, rng, lines, edges)
    probe.append(host_us(torch, lambda: x.add_(1), 2000))
    lines.append("host time of one torch add_ on the card: "
                 + ", ".join(f"{p:.1f} us" for p in probe)
                 + " (before anything, after the tier, at the end)")
    for line in lines:
        print("  " + line, flush=True)
    print("  during the timings: " + smi.summary(), flush=True)


def g_rows(edges=True, other=None):
    """Kernel G alone, on the card (under a minute with the build):
    `python3 -c "import chip_smoke as cs; cs.g_rows()"` from a checkout's
    root.  kernel_g on [2M,10] lanes of 150-nt rows (random codes, zero
    past nt 150) against the same rows rolled by one, random [262144,64]
    and [2M,1]: device time, CUDA-event time, plain time, bound and the
    wrapper's host time a call; with `edges`, G's edge cases.  Another
    checkout's G (e.g. the parent commit unpacked by `git archive` into
    build/parent/) is timed by copying this file to its root and running
    g_rows(edges=False) there, or, in turns with this one's in one
    process, by g_rows(other='build/parent') from this root."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    timer, lines = Timer(torch), []
    rng = np.random.default_rng(0)
    words = card_lanes(torch, rng, 2_000_000, 10)
    words[:, 9] &= (1 << 2 * (150 - 144)) - 1
    with SmiSampler() as smi:
        kernel_g(torch, timer, lines, words, rng, edges, other)
    for line in lines:
        print("  " + line, flush=True)
    print("  during the timings: " + smi.summary(), flush=True)


def d_against(other):
    """Kernel D of this tree and of another checkout (see load_other, e.g.
    the parent commit unpacked into build/parent/), in turns in one
    process: `python3 -c "import chip_smoke as cs;
    cs.d_against('build/parent')"`.  At kernel_d's [10M,2] random and
    [1M,6] pool shapes (the lex path, no keys), each tree's D exact
    against this tree's plain version, its CUDA-event time (median of 7)
    and its device time a launch."""
    import importlib

    import numpy as np
    import torch

    from shortseq_torch.count import device as cdev

    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    odev = importlib.import_module(load_other(other).__name__
                                   + ".count.device")
    timer, rng = Timer(torch), np.random.default_rng(0)
    for n, w, keys in ((10_000_000, 2, None), (1_000_000, 6, 300_000)):
        words = card_lanes(torch, rng, keys or n, w)
        lengths = torch.from_numpy(rng.integers(15, 33, size=keys or n)
                                   .astype(np.int32)).cuda()
        if keys:
            pick = torch.from_numpy(rng.integers(0, keys, size=n)).cuda()
            words, lengths = words[pick].contiguous(), lengths[pick]
        weights = torch.ones(n, dtype=torch.int32, device="cuda")
        perm = cdev.sort_rows(words, lengths)
        want = cdev.group_count_plain(words, lengths, weights, perm, n)
        fns = {"this tree": lambda: cdev.group_count(words, lengths, weights,
                                                     perm, n),
               f"the tree at {other}": lambda: odev.group_count(
                   words, lengths, weights, perm, n)}
        for name, fn in fns.items():
            exact(f"D [{n},{w}], {name}", fn(), want)
        times = timer(list(fns.values()))
        for (name, fn), ms in zip(fns.items(), times):
            print(f"  D [{n},{w}], {name}: {ms:.4f} ms; "
                  + launch_split(torch, fn, ("group_tile", "group_finish")),
                  flush=True)
        del words, lengths, weights, perm, want


def s_against(other, runs=9):
    """Kernel S of this tree and of another checkout (see load_other, e.g.
    the parent commit unpacked into build/parent/), in turns in one
    process: `python3 -c "import chip_smoke as cs;
    cs.s_against('build/parent')"`.  At kernel_s's [10M,2], [1.25M,2],
    [1M,6] and [2M,64] Zipf (the hash path's first family) shapes, each
    tree's S exact against this tree's, its CUDA-event ms (median and
    quartiles of `runs`, L2 flushed before each) and its device ms a
    launch; then unique_count with each tree (its own S) at [10M,2] and
    [2M,64], the tables equal."""
    import importlib

    import numpy as np
    import torch

    from shortseq_torch.count import device as cdev

    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    odev = importlib.import_module(load_other(other).__name__
                                   + ".count.device")
    timer, rng = Timer(torch), np.random.default_rng(0)
    w1, l1 = file1_words(torch, rng, 10_000_000)
    pool = card_lanes(torch, rng, 300_000, 6)
    pool_len = torch.from_numpy(rng.integers(33, 97, size=300_000)
                                .astype(np.int32)).cuda()
    pick = torch.from_numpy(rng.integers(0, 300_000, size=1_000_000)).cuda()
    w6, l6 = pool[pick].contiguous(), pool_len[pick]
    del pool, pool_len, pick
    w64, l64, _ = file2_words(torch, rng)
    keys = cdev._row_hash(w64, l64, 0)
    shard = 1_250_000
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()

    def ms_text(xs):
        q = statistics.quantiles(xs, n=4)
        return (f"{statistics.median(xs):.4f} ms (quartiles {q[0]:.4f}-"
                f"{q[2]:.4f}, {len(xs)} runs)")

    def compare(name, fns, tags):
        got = [out if isinstance(out, tuple) else (out,)
               for out in (fn() for fn in fns.values())]
        for tree, out in zip(list(fns)[1:], got[1:]):
            exact(f"{name}, {tree} against this tree", list(out),
                  list(got[0]))
        del got
        for (tree, fn), xs in zip(fns.items(),
                                  timer.samples(list(fns.values()), runs)):
            split = launch_split(torch, fn, tags) if tags else ""
            print(f"  {name}, {tree}: {ms_text(xs)}; {split}; {smi}",
                  flush=True)

    trees = {"this tree": cdev, f"the tree at {other}": odev}
    tags = ("sort_hist", "sort_plan", "sort_pass")
    for name, words, lengths in (("S [10M,2]", w1, l1),
                                 ("S [1.25M,2]", w1[:shard], l1[:shard]),
                                 ("S [1M,6]", w6, l6)):
        compare(name, {t: (lambda m=m, x=words, y=lengths: m.sort_rows(x, y))
                       for t, m in trees.items()}, tags)
    compare("S [2M,64] Zipf, hash path",
            {t: (lambda m=m: m._sort_keys(keys, l64)[:2])
             for t, m in trees.items()}, tags)
    for name, words, lengths in (("unique_count [10M,2]", w1, l1),
                                 ("unique_count [2M,64] Zipf", w64, l64)):
        weights = torch.ones(len(lengths), dtype=torch.int32, device="cuda")
        compare(name, {t: (lambda m=m, x=words, y=lengths:
                           tuple(m.unique_count(x, y, weights)))
                       for t, m in trees.items()}, ())


def count_walls(other=None, reps=5):
    """Count files 2 and 3 on the card (about two minutes with the build):
    `python3 -c "import chip_smoke as cs; cs.count_walls()"` from a
    checkout's root.  read_and_count_fastq_table(engine="device") on
    phase count's file 2 (2M reads of 150 nt, Zipf: one 64-lane bucket)
    and file 3 (1M reads of 0-300 nt: three buckets), each as sent (one
    transfer a bucket) and with SHORTSEQ_TORCH_H2D_CHUNK_ROWS=2^19 (file
    2's bucket in 4 chunks, each counted as it lands); the wall by host
    clock with its read/count split, median of `reps` calls in turns.
    With `other` (a checkout's root, see load_other, e.g. the parent
    commit unpacked into build/parent/) that tree's walls too, in turns
    with this one's, its tables holding the same rows."""
    import os

    import torch

    import shortseq_torch

    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    trees = {"this tree": shortseq_torch}
    if other is not None:
        trees[f"the tree at {other}"] = load_other(other)
    with tempfile.TemporaryDirectory() as workdir:
        files = {"file 2": zipf_file(workdir)[0],
                 "file 3": mixed_file(workdir)[0]}
        modes = {"as sent": None, "4 chunks": str(1 << 19)}
        walls, want = {}, {}
        for _ in range(reps + 1):                  # the first: warm-up
            for (fname, path), (mode, rows), (tree, mod) in \
                    itertools.product(files.items(), modes.items(),
                                      trees.items()):
                if rows is None:
                    os.environ.pop("SHORTSEQ_TORCH_H2D_CHUNK_ROWS", None)
                else:
                    os.environ["SHORTSEQ_TORCH_H2D_CHUNK_ROWS"] = rows
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                table = mod.read_and_count_fastq_table(
                    str(path), engine="device", device="cuda")
                wall = time.perf_counter() - t0
                key = (fname, mode, tree)
                if key not in walls:
                    walls[key] = []
                    assert_same_rows(live_rows(table),
                                     want.setdefault(fname, live_rows(table)),
                                     f"{fname} {mode}, {tree}")
                else:
                    walls[key].append((wall, table._read_seconds))
                del table
        os.environ.pop("SHORTSEQ_TORCH_H2D_CHUNK_ROWS", None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    for (fname, mode, tree), ws in walls.items():
        wall = statistics.median(w for w, _ in ws)
        read = statistics.median(r for _, r in ws)
        print(f"  {fname} {mode}, {tree}: wall {wall:.3f} s (read "
              f"{read:.3f} s, count {wall - read:.3f} s; walls "
              + ", ".join(f"{w:.3f}" for w, _ in ws) + f"), {smi}",
              flush=True)


class MainPath:
    """Launch counts of kernels A to I, K10 and S over the main path's runs
    only: each run starts every count at 0 and adds what it launched, in
    all (`launches`), per phase (`by_phase`) and for the last run
    (`last`); K8's reads' calls in all (`k8_calls`)."""

    def __init__(self):
        from shortseq_torch import batch
        from shortseq_torch.count import device as cdev
        from shortseq_torch.count import table
        from shortseq_torch.dist import count as dc
        from shortseq_torch.ops import bitpack, hamming, pairwise
        from shortseq_torch.umi import dedup

        self.wrappers = {"pack_validate": bitpack.pack_and_validate_u32,
                         "pairwise_hamming": pairwise.hamming_pairwise_tiled,
                         "neighbor_extract": dedup.neighbor_extract,
                         "neighbor_lists_fused": dedup.neighbor_lists_fused,
                         "unique_count": cdev.group_count,
                         "row_hash": cdev._row_hash,
                         "row_sort": cdev.sort_rows,
                         "pack_words": bitpack.pack_words_u32,
                         "unpack_ascii": bitpack.unpack_ascii,
                         "trim_words": batch.trim_words_ragged,
                         "hamming_rows": hamming.hamming_rows,
                         "bucket_send": dc.bucket_send_buffers}
        self.launches = dict.fromkeys(self.wrappers, 0)
        self.by_phase = {}
        self.last = {}
        # K8's lazy reads are torch ops; their calls are counted apart.
        self.k8 = {"most_common": table._topk_rows, "get": table._lookup,
                   "total": table._total}
        self.k8_calls = dict.fromkeys(self.k8, 0)

    def run(self, phase_name, fn, *args, **kwargs):
        for w in (*self.wrappers.values(), *self.k8.values()):
            w.launches = 0
            w.calls = 0
        out = fn(*args, **kwargs)
        for name, f in self.k8.items():
            self.k8_calls[name] += f.calls
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

    # A 512-row slab of the neighbour lists (one CSR) against the plain
    # dense check, and the lists' wall.
    words, lengths = pack_umis(uniq)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nbrs = dedup._neighbor_lists(words, lengths, 1, device="cuda")
    lists_s = time.perf_counter() - t0
    rows = csr_rows(nbrs)
    lo = int(np.random.default_rng(7).integers(0, len(uniq) - 512))
    dense = (hamming_pairwise(words[lo:lo + 512], words) <= 1).cpu().numpy()
    for r in range(512):
        want = np.setdiff1d(np.flatnonzero(dense[r]), [lo + r])
        assert np.array_equal(rows[lo + r], want), lo + r
    edges = len(nbrs.indices)

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
            f"{len(reps)} clusters; _neighbor_lists {lists_s:.3f} s for "
            f"{len(nbrs)} rows; slab "
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


def assert_same_tables(got, want, what):
    """Equal live tables, bucket by bucket, array for array: two tables
    of the device engine, whose order is unique_count's."""
    import numpy as np

    if set(got) != set(want):
        raise AssertionError(f"{what}: buckets {sorted(got)} vs "
                             f"{sorted(want)}")
    for width in got:
        if not all(np.array_equal(x, y)
                   for x, y in zip(got[width], want[width])):
            raise AssertionError(f"{what}: {width}-lane tables differ")


def assert_same_rows(got, want, what):
    """Equal live tables, bucket by bucket, as row-sorted arrays (rows
    ordered by length, then the lanes as unsigned): the device engine's
    table against the host engine's, which keeps the order of its own
    hash counter."""
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
    files["2m_150nt_zipf"] = zipf_file(workdir)
    files["1m_0-300nt"] = mixed_file(workdir)
    return files


def zipf_file(workdir):
    """The count phase's file 2: 2M reads of 150 nt, PCR duplicates drawn
    Zipf(1.2) from 200k molecules.  Returns (path, reads)."""
    import numpy as np

    alpha = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(1)
    mols = alpha[rng.integers(0, 4, size=(200_000, 150))]
    path = Path(workdir) / "reads_150nt.fastq"
    write_fastq(path, mols[zipf_pick(rng, 200_000, 2_000_000)])
    return path, 2_000_000


def mixed_file(workdir):
    """The count phase's file 3: 1M reads of 0-300 nt (all three buckets,
    empty reads) drawn from a pool of 300k reads.  Returns (path, reads)."""
    import numpy as np

    alpha = np.frombuffer(b"ACGT", np.uint8)
    rng = np.random.default_rng(2)
    pool_len = rng.integers(0, 301, size=300_000)
    pool = alpha[rng.integers(0, 4, size=int(pool_len.sum()))]
    pick = rng.integers(0, 300_000, size=1_000_000)
    lens = pool_len[pick]
    col = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens, lens)
    seqs = pool[np.repeat((np.cumsum(pool_len) - pool_len)[pick], lens) + col]
    path = Path(workdir) / "reads_mixed.fastq"
    write_fastq_ragged(path, seqs, lens)
    return path, len(lens)


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
        # The table's lazy reads (K8) are the main path's last step.
        total = main_path.run("count", dev.total)
        if not total == host.total() == n_reads:
            raise AssertionError(f"{name}: totals {total}, "
                                 f"{host.total()}, reads {n_reads}")
        top_d = [(str(k), c)
                 for k, c in main_path.run("count", dev.most_common, 20)]
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
    assert_same_tables(live_rows(streamed), tables["10m_15-32nt"][2],
                       "streamed file 1 against the whole file")
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
    # The wall is the length check's sync and host time; G's launch is
    # timed apart (outside the counted run), by CUDA events and by
    # torch.profiler (which, this late in the process, may drop it).
    g_ms = timer([lambda: hamming.hamming_rows(b.words, b2.words)])[0]
    split = launch_split(torch, lambda: hamming.hamming_rows(b.words,
                                                             b2.words),
                         ("hamming_rows",), runs=10)
    lines.append(f"hamming: {ham_s * 1e3:.3f} ms, {int(hit.sum())} known "
                 f"substitutions found; kernel G {g_ms:.4f} ms (CUDA "
                 f"events), {split}")
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


def phase_folded(torch, main_path):
    """The JAX package's row-folded and padded names on the card, driven
    once on the main path (kernel A's launches counted): bench.py's
    headline, 2^18 rows x 160 bytes of ACGT with PAD_BYTE tails (fold_for
    gives 4; pack_and_validate_folded with unfold=False and pad_valid,
    pack_folded, pack_validate_padded), and kernel A's JSON line's shape,
    [10M, 8] lanes with zero tails and 1% random bytes (fold_for gives 16;
    both names with unfold True and False, pack_validate_padded, which
    pads to 10,485,760 rows).  Each result equals pack_and_validate_plain
    or pack_words_plain on the same rows exactly; then each is timed
    (CUDA events; pack_validate_padded, which starts from host rows, by
    the host clock)."""
    import numpy as np

    from shortseq_torch.constants import PAD_BYTE
    from shortseq_torch.count import ingest
    from shortseq_torch.ops import bitpack

    rng = np.random.default_rng(8)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    n1, w1 = 1 << 18, 40
    rows1 = alpha[rng.integers(0, 4, size=(n1, 4 * w1), dtype=np.uint8)]
    lens1 = rng.integers(100, 4 * w1 + 1, size=n1).astype(np.int32)
    rows1[np.arange(4 * w1)[None, :] >= lens1[:, None]] = PAD_BYTE
    bad = rng.random(rows1.shape) < 1e-4
    rows1[bad] = rng.integers(0, 256, size=int(bad.sum()))
    x1 = torch.from_numpy(rows1.view(np.int32)).cuda()
    l1 = torch.from_numpy(lens1).cuda()

    gen = torch.Generator(device="cuda").manual_seed(23)
    n2, w2 = 10_000_000, 8
    codes = torch.randint(0, 4, (n2, 4 * w2), dtype=torch.uint8,
                          device="cuda", generator=gen)
    mat2 = torch.tensor(list(b"ACGT"), dtype=torch.uint8,
                        device="cuda")[codes.long()]
    del codes
    l2 = torch.randint(0, 4 * w2 + 1, (n2,), dtype=torch.int32,
                       device="cuda", generator=gen)
    mat2[torch.arange(4 * w2, device="cuda")[None, :] >= l2[:, None]] = 0
    hit = torch.rand(mat2.shape, device="cuda", generator=gen) < 0.01
    mat2[hit] = torch.randint(0, 256, (int(hit.sum()),), dtype=torch.uint8,
                              device="cuda", generator=gen)
    del hit
    x2 = mat2.view(torch.int32)
    rows2, lens2 = mat2.cpu().numpy(), l2.cpu().numpy()
    del mat2

    f1, f2 = bitpack.fold_for(w1, n1), bitpack.fold_for(w2, n2)
    if (f1, f2) != (4, 16):
        raise AssertionError(f"fold_for gave {f1} and {f2}, not 4 and 16")
    x1f, l1f = x1.view(n1 // f1, f1 * w1), l1.view(n1 // f1, f1)
    x2f, l2f = x2.view(n2 // f2, f2 * w2), l2.view(n2 // f2, f2)
    calls = {
        "headline pack_and_validate_folded unfold=False pad_valid":
            lambda: bitpack.pack_and_validate_folded(
                x1f, l1f, w1, unfold=False, pad_valid=True),
        "headline pack_folded unfold=False":
            lambda: [bitpack.pack_folded(x1f, w1, unfold=False)],
        "[10M,8] pack_and_validate_folded unfold=True":
            lambda: bitpack.pack_and_validate_folded(x2f, l2f, w2),
        "[10M,8] pack_and_validate_folded unfold=False":
            lambda: bitpack.pack_and_validate_folded(x2f, l2f, w2,
                                                     unfold=False),
        "[10M,8] pack_folded unfold=True":
            lambda: [bitpack.pack_folded(x2f, w2)],
        "[10M,8] pack_folded unfold=False":
            lambda: [bitpack.pack_folded(x2f, w2, unfold=False)]}
    padded = {
        "headline pack_validate_padded pad_valid":
            lambda: ingest.pack_validate_padded(rows1, lens1, pad_valid=True),
        "[10M,8] pack_validate_padded":
            lambda: ingest.pack_validate_padded(rows2, lens2)}
    got, got_padded = main_path.run(
        "folded", lambda: ({k: f() for k, f in calls.items()},
                           {k: f() for k, f in padded.items()}))

    w1p, ok1p = bitpack.pack_and_validate_plain(x1, l1, True)
    w2p, ok2p = bitpack.pack_and_validate_plain(x2, l2, False)
    pack1p, pack2p = bitpack.pack_words_plain(x1), bitpack.pack_words_plain(x2)
    nf1, nf2 = n1 // f1, n2 // f2
    want = [[w1p.view(nf1, -1), ok1p.view(nf1, -1)], [pack1p.view(nf1, -1)],
            [w2p, ok2p], [w2p.view(nf2, -1), ok2p.view(nf2, -1)], [pack2p],
            [pack2p.view(nf2, -1)]]
    for (name, g), w in zip(got.items(), want):
        exact(f"A {name}", g, w)
    del got, want, w1p, ok1p, w2p, ok2p, pack1p, pack2p
    for (name, (words, ok)), (x, ln, pad_valid) in zip(
            got_padded.items(), ((x1, l1, True), (x2, l2, False))):
        n = len(x)
        n_pad = ingest.quarter_pow2(n)
        pad = PAD_BYTE * 0x01010101
        xp = torch.cat([x, torch.full((n_pad - n, x.shape[1]), pad,
                                      dtype=torch.int32, device="cuda")])
        lp = torch.cat([ln, torch.zeros(n_pad - n, dtype=torch.int32,
                                        device="cuda")])
        pw, pok = bitpack.pack_and_validate_plain(xp, lp, pad_valid)
        exact(f"A {name}", [words, torch.from_numpy(ok)], [pw, pok[:n].cpu()])
        del xp, lp, pw, pok
    del got_padded

    timer = Timer(torch)
    for name, fn in calls.items():
        x, ln = (x1, l1) if name.startswith("headline") else (x2, l2)
        out = fn()
        bnd = bound([x, ln] if len(out) == 2 else [x], out)
        del out
        ms, = timer([fn])
        print(f"  A {name}: {ms:.4f} ms; {bound_text(bnd)}", flush=True)
    for name, fn in padded.items():
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        print(f"  A {name} (host rows in, padding and the copy included): "
              f"{statistics.median(walls) * 1e3:.1f} ms (median of 3)",
              flush=True)
    return (f"fold_for 4 and 16; {len(calls) + len(padded)} calls exact; "
            f"launches {main_path.last}")


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
        assert_same_tables({w.shape[1]: (np.asarray(w, np.uint32), lens,
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
            (w, ln), = packed_buckets(*read_fastq_index(path),
                                      pad_pow2=False)
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
        top_d = [(str(k), c)
                 for k, c in run("sharded", dct.most_common, 20)]
        top_c = [(str(k), c) for k, c in dev1.most_common(20)]
        edge = top_c[-1][1]
        if [c for _, c in top_d] != [c for _, c in top_c] or \
                [kv for kv in top_d if kv[1] > edge] != \
                [kv for kv in top_c if kv[1] > edge] or \
                any(dev1.get(k) != c for k, c in top_d):
            raise AssertionError("DistributedCountTable.most_common(20)")
        probe = top_c[0][0]
        missing = "ACGT" * 8
        if (len(dct), run("sharded", dct.total)) != \
                (len(dev1), dev1.total()) or \
                run("sharded", dct.get, probe) != dev1.get(probe) or \
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

# The 100,000-unique problem's row bands at D ranks: (D, rank, rows,
# padded columns).  Its block is 2688, so the padding quantum is 2688 * D:
# 102144 columns at D = 1 and 2, 107520 at D = 4 and 8.  D = 38 gives one
# block a rank: kernel H's band shape of phase kernels, re-timed here.
UMI_BANDS = ((2, 0, 51072, 102144), (4, 0, 26880, 107520),
             (8, 0, 13440, 107520), (8, 7, 5920, 107520),
             (38, 7, 2688, 102144))


def h_bands(torch, lines):
    """Kernel H at the row bands ranks get of the 100,000-unique 12-nt
    problem (threshold 1, k = 16), each exact against its rows of the
    whole-matrix call at the same padded column count, timed by CUDA
    events and torch.profiler beside its popcount bound."""
    import numpy as np

    from shortseq_torch.umi import dedup

    timer = Timer(torch)
    u = 100_000
    words, lengths = pack_umis(rand_umis(u, 12, seed=0))
    whole = {}
    for d, rank, rows, u_pad in UMI_BANDS:
        if u_pad not in whole:
            w = torch.zeros((u_pad, 2), dtype=torch.int32, device="cuda")
            w[:u] = words
            ln = torch.full((u_pad,), -1, dtype=torch.int32, device="cuda")
            ln[:u] = torch.from_numpy(lengths.astype(np.int32)).cuda()
            g = torch.zeros(u_pad, dtype=torch.int32, device="cuda")
            r = torch.arange(u_pad, dtype=torch.int32, device="cuda")
            cols = (w, ln, g)
            whole[u_pad] = (cols, r, dedup.neighbor_lists_fused(
                w[:u], ln[:u], g[:u], r[:u], *cols, 1, 16))
        cols, r, (idx, cnt) = whole[u_pad]
        lo = rank * (u_pad // d)
        hi = min(lo + u_pad // d, u)
        if hi - lo != rows:
            raise AssertionError(f"D = {d} rank {rank}: {hi - lo} rows")
        args = (*(t[lo:hi] for t in cols), r[lo:hi], *cols, 1, 16)
        got = dedup.neighbor_lists_fused(*args)
        exact(f"H band D={d} rank {rank}", got, (idx[lo:hi], cnt[lo:hi]))
        ms, = timer([lambda: dedup.neighbor_lists_fused(*args)])
        # Late in a long process the profiler sometimes sees none of the
        # launches: one more profile of more calls then.
        split = launch_times(torch, lambda: dedup.neighbor_lists_fused(*args),
                             ("neighbor_lists", "neighbor_merge")) \
            or launch_times(torch, lambda: dedup.neighbor_lists_fused(*args),
                            ("neighbor_lists", "neighbor_merge"), runs=10)
        dev = sum(t for t, _ in split.values()) if split else None
        bnd = bound(args[:7], got, popc=rows * u_pad)
        lines.append(
            f"H band D={d} rank {rank} [{rows}]x[{u_pad}] k=16 threshold 1: "
            f"{ms:.4f} ms ({bnd[0] / ms:.0%} of bound), device "
            + (f"{dev:.4f} ms ({bnd[0] / dev:.0%})" if dev else "not measured")
            + f"; {bound_text(bnd)}; exact against the whole matrix; "
            + ", ".join(f"{k} {t:.4f} ms x {n}" for k, (t, n) in split.items()))


def scoped_launches(torch, workdir, lines):
    """Kernels A, E, G, D, S and I (unique_count at 2 and 8 lanes) once each
    under torch.profiler (CPU and CUDA): every launch of each kernel must
    come from inside its wrapper's ssq.* range, read from the Chrome
    trace (the runtime call of
    the kernel's correlation id within the range's host interval).  Then
    the host time a call of A's and G's wrappers with no profiler active,
    with their ranges (the `scoped` wrapper) and without (the function it
    wraps), in turns (median of 5 each), and of `scoped` around an empty
    function, which leaves out the wrappers' own spread."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from shortseq_torch.count.device import unique_count
    from shortseq_torch.ops import bitpack, hamming
    from shortseq_torch.utils.profiling import scoped

    rng = np.random.default_rng(4)
    x = card_lanes(torch, rng, 4096, 8)
    ln = torch.full((4096,), 32, dtype=torch.int32, device="cuda")
    words = card_lanes(torch, rng, 4096, 2)
    ones = torch.ones(4096, dtype=torch.int32, device="cuda")
    calls = (("ssq.pack_validate", "pack_validate_kernel",
              lambda: bitpack.pack_and_validate_u32(x, ln)),
             ("ssq.unpack", "unpack_ascii_kernel",
              lambda: bitpack.unpack_ascii(words)),
             ("ssq.hamming_rows", "hamming_rows_kernel",
              lambda: hamming.hamming_rows(words, words)),
             ("ssq.unique_count", "group_tile_kernel",
              lambda: unique_count(words, ln, ones)),
             ("ssq.unique_count", "sort_pass_kernel",
              lambda: unique_count(words, ln, ones)),
             ("ssq.unique_count", "row_hash_kernel",
              lambda: unique_count(x, ln, ones)))
    for _, _, fn in calls:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(3):
            for _, _, fn in calls:
                fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    path = Path(workdir) / "scopes.trace.json"
    prof.export_chrome_trace(str(path))
    ranges, launched, kernels = {}, {}, []
    for e in json.loads(path.read_text())["traceEvents"]:
        cat, args = str(e.get("cat", "")).lower(), e.get("args") or {}
        if cat == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e.get("dur", 0)))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launched[args.get("correlation")] = e["ts"]
        elif cat == "kernel":
            kernels.append((e["name"], args.get("correlation")))
    seen = []
    for scope, name, _ in calls:
        mine = [c for k, c in kernels if name in k]
        inside = [c for c in mine if c in launched and any(
            a <= launched[c] <= b for a, b in ranges.get(scope, ()))]
        if not mine or len(inside) != len(mine):
            raise AssertionError(f"{name}: {len(inside)} of {len(mine)} "
                                 f"launches inside {scope}")
        seen.append(f"{name} {len(inside)}/{len(mine)} in {scope}")
    lines.append("under torch.profiler, every launch inside its range: "
                 + ", ".join(seen))

    a, g = x[:1024], card_lanes(torch, rng, 1024, 10)
    for name, fn, args in (("A [1024,8]", bitpack.pack_and_validate_u32,
                            (a, ln[:1024])),
                           ("G [1024,10]", hamming.hamming_rows, (g, g))):
        times = {"range": [], "no range": []}
        for _ in range(5):
            for tag, f in (("range", fn), ("no range", fn.__wrapped__)):
                times[tag].append(host_us(torch, lambda: f(*args), 2000))
        with_r, without = (statistics.median(t) for t in times.values())
        lines.append(f"{name} wrapper host time, no profiler active: "
                     f"{with_r:.2f} us a call with its range, {without:.2f} "
                     f"us without ({with_r - without:+.2f} us; "
                     + "; ".join(f"{k} " + ", ".join(f"{v:.2f}" for v in t)
                                 for k, t in times.items()) + ")")
    def empty():
        return None

    times = {"scoped": [], "alone": []}
    for _ in range(5):
        for tag, f in (("scoped", scoped("ssq.empty")(empty)),
                       ("alone", empty)):
            times[tag].append(host_us(torch, f, 20000))
    cost = statistics.median(times["scoped"]) - statistics.median(
        times["alone"])
    lines.append("an empty function, no profiler active: " + ", ".join(
        f"{k} {statistics.median(t):.3f} us a call" for k, t in times.items())
        + f" (the range's cost {cost:+.3f} us)")
    lines.append(f"torch {torch.__version__}: autograd profiler flag "
                 + ("present" if hasattr(torch.autograd.profiler,
                                         "_is_profiler_enabled")
                    else "absent (the C++ query)"))


_FIRST_CALL = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
import shortseq_torch as st
if sys.argv[3] == "torch warmup":
    # The thread without the driver API: torch's op creates the context.
    from shortseq_torch.utils import warmup
    warmup._primary_context = lambda index: True
t2 = time.perf_counter()
table = st.read_and_count_fastq_table(sys.argv[2], engine="device")
torch.cuda.synchronize()
t3 = time.perf_counter()
print(json.dumps({"import_torch": t1 - t0, "first_call": t3 - t2,
                  "rows": len(table)}))
"""


_CONTEXT = r"""
import json, time
import torch
t0 = time.perf_counter()
torch.zeros(1, device="cuda").cpu()
print(json.dumps({"context": time.perf_counter() - t0}))
"""


def warmup_walls(fastq, lines, arms=("warmup", "no warmup"), rounds=3):
    """`rounds` rounds of fresh processes, one an arm in turns, each
    counting `fastq` with the device engine as its first use of the card:
    with the CUDA warmup thread, with SHORTSEQ_TORCH_NO_WARMUP=1, or
    ("torch warmup") with the thread's context made by a torch op instead
    of the driver API.  The first call's wall (after `import torch`, timed
    apart) of each; then one process that times what the thread does
    alone (the context and a first copy), the most the warmup can hide."""
    import os

    walls = {arm: [] for arm in arms}
    rows = set()
    for _ in range(rounds):
        for tag in walls:
            env = {k: v for k, v in os.environ.items()
                   if k != "SHORTSEQ_TORCH_NO_WARMUP"}
            if tag == "no warmup":
                env["SHORTSEQ_TORCH_NO_WARMUP"] = "1"
            proc = subprocess.run(
                [sys.executable, "-c", _FIRST_CALL, str(ROOT), str(fastq),
                 tag], cwd=ROOT, env=env, capture_output=True, text=True,
                timeout=60)
            if proc.returncode != 0:
                raise RuntimeError(f"first call ({tag}) exit "
                                   f"{proc.returncode}: {proc.stderr[-2000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            walls[tag].append((got["first_call"], got["import_torch"]))
            rows.add(got["rows"])
    if len(rows) != 1:
        raise AssertionError(f"first calls disagree: {rows} rows")
    proc = subprocess.run([sys.executable, "-c", _CONTEXT], cwd=ROOT,
                          capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"context alone exit {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    context = json.loads(proc.stdout.strip().splitlines()[-1])["context"]
    lines.append(f"the CUDA context and a first copy alone, in a fresh "
                 f"process: {context:.3f} s")
    for tag, w in walls.items():
        first = [c for c, _ in w]
        lines.append(f"first call, {tag}: " + ", ".join(
            f"{c:.3f} s" for c in first) + f" (median "
            f"{statistics.median(first):.3f} s, quartiles "
            f"{quartiles(first)} s; import torch "
            + ", ".join(f"{t:.3f}" for _, t in w) + " s)")
    if "no warmup" in walls:
        none = [c for c, _ in walls["no warmup"]]
        for tag, w in walls.items():
            if tag != "no warmup":
                wins = sum(c < n for (c, _), n in zip(w, none))
                lines.append(f"{tag} faster than no warmup in {wins} of "
                             f"{len(none)} rounds")


def phase_umi_mesh(torch, main_path, workdir, fastq):
    """The sharded UMI dedup under a one-rank NCCL group: dedup_umis and
    dedup_reads with mesh= against the no-mesh calls on the card, the
    overflow tier under the mesh against the CPU, kernel H at the bands
    of 2, 4 and 8 ranks, the ssq.* ranges under the profiler and their
    host cost, and the CUDA warmup's first-call walls on `fastq`.  Its
    lines are printed even when a check fails."""
    lines = []
    try:
        umi_mesh_checks(torch, main_path, workdir, fastq, lines)
    finally:
        for line in lines:
            print("  " + line, flush=True)
    return "all checks passed"


def umi_mesh_checks(torch, main_path, workdir, fastq, lines):
    import numpy as np

    from shortseq_torch.dist import mesh as dm
    from shortseq_torch.umi import dedup

    def same(got, want, what):
        if not (np.array_equal(got[0], want[0]) and got[1] == want[1]):
            raise AssertionError(f"{what}: mesh= differs from no mesh")

    def wall(fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        return out, time.perf_counter() - t0

    init = Path(workdir) / "pg_umi"
    init.unlink(missing_ok=True)
    dm.initialize_distributed(init_method=f"file://{init}", rank=0,
                              world_size=1, device="cuda", timeout=300)
    try:
        mesh = dm.data_mesh(device="cuda")
        backend = torch.distributed.get_backend()
        if not (mesh.distributed and mesh.size == 1 and backend == "nccl"
                and mesh.device.type == "cuda"):
            raise AssertionError(f"mesh {mesh}, backend {backend}")

        umis = rand_umis(100_000, 12, seed=0) * 3
        kw = dict(threshold=1, method="directional")
        got = main_path.run("umi_mesh", dedup.dedup_umis, umis, mesh=mesh,
                            **kw)
        want = dedup.dedup_umis(umis, device="cuda", **kw)
        same(got, want, "dedup_umis 100,000 unique x 3")
        walls = {"mesh": [], "no mesh": []}
        for _ in range(3):
            walls["no mesh"].append(wall(dedup.dedup_umis, umis,
                                         device="cuda", **kw)[1])
            walls["mesh"].append(wall(dedup.dedup_umis, umis, mesh=mesh,
                                      **kw)[1])
        lines.append(
            f"dedup_umis, {len(umis)} UMIs (100,000 unique), equal to no "
            "mesh: " + "; ".join(
                f"{k} {statistics.median(v):.3f} s (" + ", ".join(
                    f"{x:.3f}" for x in v) + ")" for k, v in walls.items()))

        mat, _ = make_reads(1_000_000, 100_000)
        got, mesh_s = wall(main_path.run, "umi_mesh", dedup.dedup_reads, mat,
                           len_5p=8, mesh=mesh)
        want, plain_s = wall(dedup.dedup_reads, mat, len_5p=8, device="cuda")
        same(got, want, "dedup_reads 1M reads")
        lines.append(f"dedup_reads, 1,000,000 reads -> {len(got[1])} "
                     f"molecules, equal to no mesh: mesh {mesh_s:.3f} s, no "
                     f"mesh {plain_s:.3f} s")

        fans = fan_umis(200, 12, seed=5)
        over = main_path.run("umi_mesh", dedup.dedup_umis, fans, threshold=2,
                             mesh=mesh)
        ran = main_path.last
        if not (ran["neighbor_lists_fused"] and ran["pairwise_hamming"]
                and ran["neighbor_extract"]):
            raise AssertionError(f"the overflow tier did not run: {ran}")
    finally:
        torch.distributed.destroy_process_group()

    with SmiSampler() as smi:
        h_bands(torch, lines)
    lines.append("during H's band timings: " + smi.summary())
    scoped_launches(torch, workdir, lines)
    # The CPU reference after the timings: heavy CPU torch work slows the
    # host's later launches.
    same(over, dedup.dedup_umis(fans, threshold=2, device="cpu"),
         "fan UMIs at threshold 2 (against device='cpu')")
    lines.append(f"{len(fans)} fan UMIs at threshold 2 under the mesh: "
                 f"{len(over[1])} clusters, equal to cpu, launches H "
                 f"{ran['neighbor_lists_fused']}, B {ran['pairwise_hamming']}, "
                 f"C {ran['neighbor_extract']}")
    warmup_walls(fastq, lines)


def warmup_check(rounds=10):
    """The CUDA warmup alone, on the card (about five minutes with the
    build): `python3 -c "import chip_smoke as cs; cs.warmup_check()"`.
    Writes count's file 3, then warmup_walls with the driver-API thread,
    the torch-op thread and no thread, `rounds` rounds in turns."""
    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    lines = []
    with tempfile.TemporaryDirectory() as workdir:
        fastq, _ = mixed_file(workdir)
        warmup_walls(fastq, lines, ("warmup", "torch warmup", "no warmup"),
                     rounds)
    for line in lines:
        print("  " + line, flush=True)


def umi_mesh():
    """Phase umi_mesh alone, on the card (about two minutes with the
    build): `python3 -c "import chip_smoke as cs; cs.umi_mesh()"` from a
    checkout's root.  Writes count's file 3 for the warmup's walls."""
    import torch

    sys.path.insert(0, str(ROOT))
    phase("build", phase_build)
    with tempfile.TemporaryDirectory() as workdir:
        fastq, _ = mixed_file(workdir)
        phase("umi_mesh", phase_umi_mesh, torch, MainPath(), workdir, fastq)


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
    from shortseq_torch.dist import umi as dist_umi
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
    for module, name in ((dedup, "_dedup_umis_ragged"),
                         (dedup, "_dedup_reads_ragged"),
                         (counter, "count_indexed_device_table"),
                         (counter, "_read_and_count_table_streamed"),
                         (counter, "_h2d_chunks"),
                         (pipeline, "count_fastq_sharded"),
                         (pipeline, "read_and_count_fastq_distributed"),
                         (dist_umi, "neighbors_sharded_step")):
        real = getattr(module, name)

        def counted(*a, _real=real, _name=name, **k):
            out = _real(*a, **k)
            if _name != "_h2d_chunks" or out == 4:
                paths[_name] = paths.get(_name, 0) + 1
            return out

        # wraps: the wrapped functions' counters stay reachable by name.
        setattr(module, name, functools.wraps(real)(counted))
    with tempfile.TemporaryDirectory() as workdir:
        # Every run calibrates the pairwise selector afresh, into workdir.
        pairwise._calib_file = lambda: str(Path(workdir) / "calib.json")
        phase("umi_scale", phase_umi_scale, torch, main_path)
        phase("umi_cli", phase_umi_cli, torch, main_path, workdir)
        phase("count", phase_count, torch, main_path, workdir, found)
        phase("batch", phase_batch, torch, main_path, workdir, found)
        phase("folded", phase_folded, torch, main_path)
        phase("sharded", phase_sharded, torch, main_path, workdir, found,
              results)
        del found["tables"]
        phase("umi_mesh", phase_umi_mesh, torch, main_path, workdir,
              found.pop("files")["1m_0-300nt"][0])
    launches = main_path.launches

    def counters():
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
        if main_path.by_phase["count"]["unique_count"] == 0:
            raise AssertionError("kernel D never launched in phase count")
        quiet = [p for p in ("count", "batch")
                 if main_path.by_phase[p]["row_hash"] == 0]
        if quiet:
            raise AssertionError(f"kernel I never launched in {quiet}")
        quiet = [p for p in ("count", "batch", "sharded")
                 if main_path.by_phase[p]["row_sort"] == 0]
        if quiet:
            raise AssertionError(f"kernel S never launched in {quiet}")
        umi = {p: main_path.by_phase[p]
               for p in ("umi_scale", "umi_cli", "umi_mesh")}
        quiet = [p for p, n in umi.items() if n["neighbor_lists_fused"] == 0]
        if quiet:
            raise AssertionError(f"kernel H never launched in {quiet}")
        quiet = [p for p in ("umi_scale", "umi_mesh")
                 if not (umi[p]["pairwise_hamming"]
                         and umi[p]["neighbor_extract"])]
        if quiet:
            raise AssertionError("kernels B + C never launched in the "
                                 f"overflow tier of phase {quiet}")
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
        in_folded = main_path.by_phase["folded"]
        if (in_folded["pack_validate"], in_folded["pack_words"]) != (5, 3):
            raise AssertionError(f"kernel A in phase folded: {in_folded}")
        in_sharded = main_path.by_phase["sharded"]
        if in_sharded["bucket_send"] == 0:
            raise AssertionError("K10 never launched in phase sharded")
        if sorted(found["tiers"]) != [1, 2, 3]:
            raise AssertionError(f"merge tiers taken: {found['tiers']}")
        if native.get_lib() is None:
            raise AssertionError("native host library not loaded")
        want = {"_dedup_umis_ragged", "_dedup_reads_ragged",
                "count_indexed_device_table",
                "_read_and_count_table_streamed", "_h2d_chunks",
                "count_fastq_sharded", "read_and_count_fastq_distributed",
                "neighbors_sharded_step"}
        if set(paths) != want:
            raise AssertionError(f"paths not all taken: {paths}")
        return (f"launches {launches}, in phase umi_scale "
                f"{umi['umi_scale']}, in phase umi_cli {umi['umi_cli']}, "
                f"in phase count "
                f"{main_path.by_phase['count']}, in phase batch {in_batch} "
                f"(pairwise path {found['batch_pairwise']}), in phase "
                f"folded {in_folded}, in phase "
                f"sharded {in_sharded} (merge tiers {found['tiers']}), in "
                f"phase umi_mesh {umi['umi_mesh']}, A in "
                f"count_matrix_device {found['matrix_pack_validate']}; "
                f"K8 calls (torch ops) {main_path.k8_calls}; "
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
