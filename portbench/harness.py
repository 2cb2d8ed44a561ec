"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result line.

Set-up (timed as setup_s, from the process's start): the library's
FASTQ is generated from the seed by traffic.py in a child process while
this one imports torch and the program and loads its kernels (built
into the checkout's build/shortseq_torch/ on the first run); then one
warm-up call of the cell's own entry.

Window: a closed loop, one client.  The entry runs library after
library until `seconds` have passed; the window ends when the last call
returns.  With trace 1 the window runs under torch.profiler, and the
per-layer metrics are read from the trace and the spans.

Check: once the window has closed and the peaks are read, the reference
counts the FASTQ itself and the entry compares every call's answers and
the whole output of one call drawn from the seed (see entries/).

Peaks: the harness keeps one call's output (a table on the card, a
dict on the host) through the window for that check, so the peaks it
reports (the card's over the window, the host's ru_maxrss) are taken
less the bytes that the allocator and the resident set give back when
the harness lets go of one kept output.

A metric's reader (metrics/<name>.py) may ask the harness for more than
the run's record: `COUNTERS`, program counters ("module:attr.attr") whose
growth over the window it reads from `run.counters`; `LAUNCHES`, {kernel
name in the trace: counter}, which a traced run checks against the
trace; and `probe(program)`, an object with `reset()` and `undo()` put
in place after the warm-up, reset at the window's start, undone after
it, and handed back in `run.probes[<metric name>]`.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import io
import json
import os
import random
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import manifest
import roofline
import smi
import spans as spans_mod
import tracefile

HERE = Path(__file__).resolve().parent
#: Top-level module names that no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "shortseq_tpu")
def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@contextlib.contextmanager
def environment(env: dict):
    """The mix's environment variables, set for the block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def start_library(config_path: Path, seed: int, out: Path):
    return subprocess.Popen([sys.executable, str(HERE / "traffic.py"),
                             str(config_path), str(seed), str(out)])


def finish_library(proc) -> None:
    if proc.wait() != 0:
        raise RuntimeError(f"traffic.py exited {proc.returncode}")


def build(device) -> None:
    """Load the program's kernels and host libraries (built into the
    checkout on the first run)."""
    from shortseq_torch import _build
    from shortseq_torch.io.native import get_lib

    if device.type == "cuda":
        _build.cuda_lib()
    _build.load_objects()
    get_lib()


def counter_value(spec: str) -> int:
    """The program counter named "module:attr.attr"."""
    mod, _, path = spec.partition(":")
    obj = importlib.import_module(mod)
    for part in path.split("."):
        obj = getattr(obj, part)
    return int(obj)


def resident_bytes() -> int:
    """The process's resident set now (VmRSS), in bytes; 0 where the
    system gives none."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def program_modules() -> list:
    return [m for name, m in list(sys.modules.items())
            if name.split(".")[0] == "shortseq_torch" and m is not None]


def measure(bench, cell, seed, seconds, trace, device, workdir, t0,
            library=None, log=None):
    """Set up, run the window, check; returns (result dict, lines for
    standard error).  `library` is the generator's running child (its
    FASTQ at workdir/library.fastq), or None to generate in-process."""
    import torch

    log = [] if log is None else log
    device = torch.device(device)
    _, config = bench.config(cell["config"])
    mix = bench.mix(cell["traffic"])
    entry = bench.entry(mix["entry"])
    fastq = Path(workdir) / "library.fastq"
    reads = int(config["library"]["reads"])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    with environment(mix.get("env", {})):
        import shortseq_torch as st

        build(device)
        t_built = time.perf_counter()
        if library is None:
            import traffic

            traffic.write(config["library"], seed, fastq)
        else:
            finish_library(library)
        t_lib = time.perf_counter()
        sp = spans_mod.Spans(trace)
        sp.new_call()
        with contextlib.redirect_stdout(io.StringIO()):
            _, held, _ = entry.call(st, str(fastq), mix, sp, device)
        sync()
        t_warm = time.perf_counter()
        setup_s = t_warm - t0
        log.append(f"set-up {setup_s:.3f} s: kernels and libraries loaded "
                   f"at {t_built - t0:.3f} s, library ready at "
                   f"{t_lib - t0:.3f} s, warm-up call {t_warm - t_lib:.3f} s")

        readers = {m["name"]: bench.reader(m["name"])
                   for m in bench.metrics(cell["name"], bool(trace))}
        launches = {k: v for r in readers.values()
                    for k, v in getattr(r, "LAUNCHES", {}).items()} \
            if trace else {}
        specs = sorted({c for r in readers.values()
                        for c in getattr(r, "COUNTERS", ())}
                       | set(launches.values()))
        program = SimpleNamespace(package=st, modules=program_modules())
        probes = {n: r.probe(program) for n, r in readers.items()
                  if hasattr(r, "probe")}

        sp = spans_mod.Spans(trace)
        keep = random.Random(seed)
        calls, answers, failed = [], [], 0
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        sampler = smi.Sampler() if trace and cuda else contextlib.nullcontext()

        def allocated():
            return torch.cuda.memory_allocated() if cuda else 0

        holds = []  # (device, host) bytes freed as the harness lets go
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        start_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        before = {c: counter_value(c) for c in specs}
        for p in probes.values():
            p.reset()
        with sampler:
            window = torch.profiler.record_function(tracefile.WINDOW) \
                if trace else contextlib.nullcontext()
            t_start = time.perf_counter()
            with window:
                while time.perf_counter() - t_start < seconds:
                    rec = sp.new_call()
                    c0 = time.perf_counter()
                    try:
                        with contextlib.redirect_stdout(io.StringIO()):
                            answer, out, read_s = entry.call(
                                st, str(fastq), mix, sp, device)
                        ok = True
                    except Exception:
                        if not failed:
                            log.append("a call failed:\n"
                                       + traceback.format_exc())
                        failed += 1
                        ok, out, read_s = False, None, 0.0
                    calls.append({"wall": time.perf_counter() - c0,
                                  "read_s": read_s, "spans": rec, "ok": ok})
                    if ok:
                        answers.append(answer)
                        # One call's whole output, drawn from the seed
                        # (reservoir); the warm-up's is held until then.
                        if keep.randrange(len(answers)) == 0:
                            dev0, rss0 = allocated(), resident_bytes()
                            held, out = out, None  # the last kept goes
                            holds.append((dev0 - allocated(),
                                          rss0 - resident_bytes()))
                    del out
                sync()
            window_s = time.perf_counter() - t_start
        raw_dev = torch.cuda.max_memory_allocated() if cuda else 0
        raw_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        # Every call ran beside one kept output; all are of one size, and
        # the least that letting one go gave back is taken off.
        hold_dev = min((max(0, d) for d, _ in holds), default=0)
        hold_rss = min((max(0, r) for _, r in holds), default=0)
        peak_dev, peak_rss = raw_dev - hold_dev, raw_rss - hold_rss
        counters = {c: counter_value(c) - before[c] for c in specs}
        tr = None
        if prof is not None:
            prof.__exit__(None, None, None)
            path = Path(workdir) / "trace.json"
            prof.export_chrome_trace(str(path))
            tr = tracefile.Trace.load(path)
            path.unlink()
        for p in probes.values():
            p.undo()

    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, reads=reads, calls=calls,
        peak_device_bytes=peak_dev, peak_rss_bytes=peak_rss, trace=tr,
        counters=counters, probes=probes,
        hbm_bytes_per_s=roofline.HBM_BYTES_PER_S.get(kind) if cuda else None)
    metrics = {}
    for m in bench.metrics(cell["name"], bool(trace)):
        value = readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    walls = [c["wall"] for c in calls]
    log.append(f"window {window_s:.3f} s: {len(calls)} library calls "
               f"({failed} failed) of {reads} reads; walls "
               f"{min(walls, default=0):.4f}-{max(walls, default=0):.4f} s")
    log.append("calls (wall s / read s): " + " ".join(
        f"{c['wall']:.3f}/{c['read_s']:.3f}" for c in calls))
    log.append(f"peaks: device {raw_dev} B less the kept output's "
               f"{hold_dev} B; host {raw_rss} B (ru_maxrss; "
               f"{start_rss} B at the window's start) less {hold_rss} B; "
               f"given back as kept outputs were let go "
               f"(device, host): {holds}")
    device_rec = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                  "count": int(cell["chips"]),
                  "memory_peak_bytes": int(peak_dev)}
    breakdown = None
    if tr is not None:
        device_rec["busy_s"] = tr.busy_us() / 1e6
        device_rec["window_s"] = tr.window_us / 1e6
        breakdown = {"device_ops": tracefile.top(tr.op_totals()),
                     "idle_gaps": tracefile.top(tr.idle_by_label())}
        seen = ", ".join(f"{k} {tr.count(k)} seen / {counters[c]} counted"
                         for k, c in launches.items())
        log.append(f"launches in the window, trace against the program's "
                   f"counters: {seen}")
        for name, p in probes.items():
            log.append(f"probe of {name}: {p}")
        if isinstance(sampler, smi.Sampler):
            log.append(sampler.summary())

    # The check: the program's state freed, the reference on the card.
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    from reference import count as ref_count

    ref = ref_count.count_fastq(fastq, device)
    checks = entry.check(answers, held, ref, mix,
                         random.Random(seed)) if answers else {}
    del held
    log.append(f"reference: {ref.reads} reads, {ref.counts.numel()} unique; "
               f"check {time.perf_counter() - t_ref:.3f} s")
    limits = entry.LIMITS
    correct = (bool(answers) and failed == 0 and set(checks) == set(limits)
               and all(checks[k] <= limits[k] for k in limits))
    result = {"correct": correct, "attempted": len(calls), "failed": failed,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": checks.get(k), "limit": limits[k]}
                        for k in limits}
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    return result, log


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("the run loaded " + ", ".join(names))
        self.names = names


def main(argv, t0) -> int:
    args = parse(argv)
    bench = manifest.Bench()
    cell = bench.cell(args.workload)
    config_path, _ = bench.config(cell["config"])
    workdir = Path(tempfile.mkdtemp(prefix="portbench-"))
    library = None
    try:
        library = start_library(config_path, args.seed,
                                workdir / "library.fastq")
        query = smi.Query()
        import torch

        log = [f"card: {query.result()}"]
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < int(cell["chips"]):
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"{have} available", file=sys.stderr)
            return 2
        try:
            result, log = measure(bench, cell, args.seed, args.seconds,
                                  args.trace, "cuda", workdir, t0, library,
                                  log)
        except ForbiddenModules as e:
            print(f"{e}: no result", file=sys.stderr)
            return 3
        library = None
    finally:
        if library is not None and library.poll() is None:
            library.kill()
            library.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    report(result, log)
    return 0


def report(result, log) -> None:
    """The run's lines on standard error, each compared number beside its
    limit last; the result as the last line of standard output."""
    for line in log:
        print(line, file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
