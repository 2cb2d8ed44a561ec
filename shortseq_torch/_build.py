"""Build and load, at first use, the three native libraries of the port.

* CUDA: every `shortseq_torch/csrc/*.cu` compiled by nvcc for sm_90a into
  one shared library with a plain C interface, bound with ctypes.  A
  failed build raises with nvcc's own message: the device path never
  gives way to the plain PyTorch versions.
* Host: the unchanged `csrc/fastq_index.cpp` (FASTQ indexer, gather +
  pack, hash counter, greedy UMI collapse) compiled by g++ exactly as the
  JAX package builds it.  Host code keeps that package's behaviour when
  no compiler is present: callers take their pure-Python paths.
* Objects: the unchanged `csrc/shortseq_native.cpp` (the C ShortSeq
  types) compiled by g++ against the interpreter's headers and loaded as
  the extension module `shortseq_torch._native`.  When it cannot be
  built, or SHORTSEQ_TORCH_FORCE_PYTHON=1, the pure-Python object layer
  (api/seq.py) serves with identical semantics.

All land under `build/shortseq_torch/` at the repository root, named by a
hash of their sources and flags, and are published by an atomic rename so
a concurrent process never loads a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sysconfig
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "shortseq_torch"
_HOST_SRC = _PKG.parent / "csrc" / "fastq_index.cpp"
_OBJECTS_SRC = _PKG.parent / "csrc" / "shortseq_native.cpp"

NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*NVCC_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread"]

_lock = threading.Lock()
_cuda = None
_objects = None
_objects_tried = False


def force_python() -> bool:
    """SHORTSEQ_TORCH_FORCE_PYTHON=1: use neither g++ library (the host
    code's pure-Python paths and object layer serve instead)."""
    return os.environ.get("SHORTSEQ_TORCH_FORCE_PYTHON", "") == "1"


def isa_token() -> str:
    """Host-ISA part of the host library's name: it is built with
    -march=native, so a build directory shared by unlike hosts must not
    hand one host's library to another (from shortseq_tpu/native_build.py)."""
    import platform

    probe = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    probe += line
                    break
    except OSError:
        pass
    return hashlib.sha256(probe.encode()).hexdigest()[:8]


def _digest(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(cmd, out: Path, timeout: int) -> subprocess.CompletedProcess:
    """Run a compiler into a private temporary name and publish it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    try:
        proc = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode == 0:
            os.replace(tmp, out)
        return proc
    finally:
        tmp.unlink(missing_ok=True)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and on PATH): the CUDA "
            "kernels of shortseq_torch cannot be built")
    return found


def build_cuda() -> Path:
    """Path of the kernels' shared library, compiling it if needed: one
    nvcc per source, all started together, then one link.  Raises
    RuntimeError with nvcc's stderr when the build fails."""
    sources = sorted((_PKG / "csrc").glob("*.cu"))
    digest = _digest(sources, NVCC_FLAGS)
    out = BUILD_DIR / f"libssq_kernels_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{s.stem}_{digest}.tmp{os.getpid()}.o"
            for s in sources]
    procs = []
    try:
        for src, obj in zip(sources, objs):
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        errors = []
        for src, proc in zip(sources, procs):
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                errors.append(f"{src.name} (exit {proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed building " + "\n".join(errors))
        proc = _compile([nvcc, *NVCC_ARCH, "-shared", *map(str, objs)], out,
                        600)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}) linking "
                f"{', '.join(s.name for s in sources)}:\n{proc.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def build_host() -> Path | None:
    """Path of the host library, or None when it cannot be built here."""
    if not _HOST_SRC.exists():
        return None
    flags = [*GXX_FLAGS, isa_token()]
    out = BUILD_DIR / f"libssq_host_{_digest([_HOST_SRC], flags)}.so"
    if out.exists():
        return out
    try:
        proc = _compile(["g++", *GXX_FLAGS, str(_HOST_SRC)], out, 180)
    except (OSError, subprocess.SubprocessError):
        return None
    return out if proc.returncode == 0 else None


def build_objects() -> Path | None:
    """Path of the object extension, or None when it cannot be built here
    (no g++ or no Python headers)."""
    if not _OBJECTS_SRC.exists():
        return None
    include = sysconfig.get_paths()["include"]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    flags = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             f"-I{include}"]
    out = BUILD_DIR / (f"_native_{_digest([_OBJECTS_SRC], flags)}_"
                       f"{isa_token()}{suffix}")
    if out.exists():
        return out
    try:
        proc = _compile(["g++", *flags, str(_OBJECTS_SRC)], out, 180)
    except (OSError, subprocess.SubprocessError):
        return None
    return out if proc.returncode == 0 else None


def load_objects():
    """The `shortseq_torch._native` module, built on first call, or None
    when it cannot be built or loaded (or SHORTSEQ_TORCH_FORCE_PYTHON=1)."""
    global _objects, _objects_tried
    with _lock:
        if _objects_tried:
            return _objects
        _objects_tried = True
        if force_python():
            return None
        path = build_objects()
        if path is None:
            return None
        import importlib.machinery
        import importlib.util

        name = "shortseq_torch._native"
        try:
            loader = importlib.machinery.ExtensionFileLoader(name, str(path))
            spec = importlib.util.spec_from_loader(name, loader)
            mod = importlib.util.module_from_spec(spec)
            loader.exec_module(mod)
        except (ImportError, OSError):
            # A corrupt build must degrade to the pure-Python layer, and
            # dropping it lets the next run rebuild cleanly.
            path.unlink(missing_ok=True)
            return None
        _objects = mod
        return _objects


#: The JAX package's name for load_objects (shortseq_tpu/native_build.py).
load = load_objects


_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int
_CUDA_SIGNATURES = {
    # x, lengths, words, ok (None: pack only), n, w, pad_valid, stream
    "ssq_pack_validate": [_P, _P, _P, _P, _I64, _I32, _I32, _P],
    # a, b, out, n, m, w, stream
    "ssq_pairwise_hamming": [_P, _P, _P, _I64, _I64, _I32, _P],
    # dist, a_len, a_gid, a_rows, len, gid, idx, cnt, rows, u,
    # threshold, k, segs (0: the kernel's choice), stream
    "ssq_neighbor_extract": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64,
                             _I32, _I32, _I32, _P],
    # rows, u, k, sms -> column ranges of one ssq_neighbor_lists launch
    "ssq_neighbor_lists_splits": [_I64, _I64, _I32, _I32],
    # a_words, a_len, a_gid, a_rows, words, len, gid, sidx, scnt, idx,
    # cnt, rows, u, w, threshold, k, sms, stream
    "ssq_neighbor_lists": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64,
                           _I64, _I32, _I32, _I32, _I32, _P],
    # words, lengths, weights, perm, s_hash (None: no collision check),
    # scratch, sums, u_words, u_lengths, n_unique, n, w, n_out, stream
    "ssq_group_tile": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                       _I64, _P],
    # words, lengths, keys, n, w, seed, stream
    "ssq_row_hash": [_P, _P, _P, _I64, _I32, ctypes.c_uint32, _P],
    # u_words, u_lengths, counts, sums, scratch, n_out, w, stream
    "ssq_group_finish": [_P, _P, _P, _P, _P, _I64, _I32, _P],
    "ssq_group_tile_rows": [],
    # words (None on the hash path), w, lengths, keys, idx_in, part,
    # scratch, key_buf, idx_buf, perm, s_hash, order, n, stream
    "ssq_sort": [_P, _I32, _P, _P, _P, _I32, _P, _P, _P, _P, _P, _P, _I64,
                 _P],
    "ssq_sort_tile_rows": [],
    # wide -> blocks of S's digit pass resident on the card at once
    "ssq_sort_resident_blocks": [_I32],
    # words, out, total (words), stream
    "ssq_unpack_ascii": [_P, _P, _I64, _P],
    # words, lengths, starts (None: start), new_lengths (None: length),
    # start, length, out, out_len, n, w, out_w, stream
    "ssq_trim_words": [_P, _P, _P, _P, _I32, _I32, _P, _P, _I64, _I32, _I32,
                       _P],
    # a, b, out, n, w, stream
    "ssq_hamming_rows": [_P, _P, _P, _I64, _I32, _P],
    # w -> rows a block of ssq_hamming_rows owns
    "ssq_hamming_block_rows": [_I32],
    # words, lengths, weights, scratch, send_words, send_lengths,
    # send_weights, overflow, n, w, d, cap, tile_rows, n_tiles, vec_bytes,
    # one_pass, zeroed, stream
    "ssq_bucket_send": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32, _I32,
                        _I64, _I64, _I64, _I32, _I32, _I64, _P],
}


def cuda_lib():
    """The loaded kernels' library, built on first call.  Raises when the
    build or the load fails."""
    global _cuda
    with _lock:
        if _cuda is None:
            lib = ctypes.CDLL(str(build_cuda()))
            for name, argtypes in _CUDA_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.ssq_error_string.argtypes = [ctypes.c_int]
            lib.ssq_error_string.restype = ctypes.c_char_p
            _cuda = lib
        return _cuda


_entries = {}


def _current_stream() -> int:
    """The current CUDA stream's handle, read without building a Stream
    object (a few microseconds less per launch)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is None:
        return torch.cuda.current_stream().cuda_stream
    return raw(torch.cuda.current_device())


def launch(name: str, *args) -> None:
    """Call one kernel entry point on the current CUDA stream and raise
    if the launch reports an error."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(cuda_lib(), name)
    err = fn(*args, _current_stream())
    if err != 0:
        msg = cuda_lib().ssq_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def resolve_device(device) -> torch.device:
    """torch.device(device), raising when it names CUDA and there is no
    card: a device path never carries on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' needs a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions")
    return device


def check_operand(t, name: str, dtype, ndim: int, device) -> None:
    """Raise unless `t` is a contiguous tensor of the given dtype and rank
    on `device`: the kernels read raw pointers with these assumptions."""
    if t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name}: expected a {ndim}-D {dtype} tensor, got "
                        f"{t.dim()}-D {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
