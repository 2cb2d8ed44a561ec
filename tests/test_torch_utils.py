"""shortseq_torch.utils and shortseq_torch.config against shortseq_tpu's:
the phase timer, the debug dumps (tests/test_utils.py's cases), deep
object sizes (tests/test_memory_bench.py's), the CUDA warmup's rules, and
the pipeline configuration."""

import dataclasses
import re

import numpy as np
import pytest
import torch

import shortseq_torch.utils.debug as tdebug
import shortseq_torch.utils.memory as tmemory
import shortseq_torch.utils.profiling as tutils
import shortseq_torch.utils.warmup as twarmup
import shortseq_tpu.utils.debug as jdebug
import shortseq_tpu.utils.memory as jmemory
import shortseq_tpu.utils.profiling as jutils
from shortseq_torch.config import DEFAULT_CONFIG, PipelineConfig
from shortseq_torch.count.ingest import WIDTH_EDGES
from shortseq_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT


@pytest.mark.parametrize("mod", [tutils, jutils], ids=["torch", "jax"])
def test_phase_timer_accumulates(mod):
    t = mod.PhaseTimings()
    with mod.phase_timer("read", t):
        pass
    with mod.phase_timer("read", t):
        pass
    with mod.phase_timer("count", t):
        pass
    assert set(t.phases) == {"read", "count"}
    assert "read:" in t.report()


@pytest.mark.parametrize("mod", [tutils, jutils], ids=["torch", "jax"])
def test_phase_timer_echo(mod, capsys):
    with mod.phase_timer("pack", echo=True):
        pass
    assert re.match(r"pack: \d+\.\d\ds\n$", capsys.readouterr().out)


def test_report_format_matches_jax():
    got, want = tutils.PhaseTimings(), jutils.PhaseTimings()
    for t in (got, want):
        t.add("read", 1.234)
        t.add("count", 0.5)
        t.add("read", 1.0)
    assert got.report() == want.report() == "read: 2.23s, count: 0.50s"
    assert tutils.PhaseTimings().report() == ""


def test_pipeline_config_matches_jax():
    """The port keeps the fields its pipeline reads, with JAX's defaults;
    the width classes are ingest's fixed edges, equal to JAX's."""
    mine = dataclasses.asdict(DEFAULT_CONFIG)
    assert set(mine) == {"batch_size", "checkpoint_dir"}
    jax_fields = dataclasses.asdict(JAX_DEFAULT)
    assert mine == {k: jax_fields[k] for k in mine}
    assert tuple(w for _, _, w in WIDTH_EDGES) == \
        JAX_DEFAULT.bucket_widths == (32, 96, 1024)
    with pytest.raises(dataclasses.FrozenInstanceError):
        DEFAULT_CONFIG.batch_size = 3
    cfg = PipelineConfig(batch_size=64, checkpoint_dir="ck")
    assert (cfg.batch_size, cfg.checkpoint_dir) == (64, "ck")


# --- debug dumps (tests/test_utils.py's cases, both packages) --------------

WORDS = np.array([[0x1B, 0], [0xFFFFFFFF, 0x80000001], [5, 7]], np.uint32)


@pytest.mark.parametrize("value, bits", [
    (0x1B, 8), (0x1B, 64), (0xFFFFFFFF, 32), (-1, 32), (0x0123456789ABCDEF, 64),
    (2**70 + 3, 64)])
def test_printbin_matches_jax(value, bits):
    assert tdebug.printbin(value, bits=bits) == \
        jdebug.printbin(value, bits=bits)
    assert tdebug.printbin(value, bits=bits, group=4) == \
        jdebug.printbin(value, bits=bits, group=4)


def test_printbin_groups_lsb_first():
    # ACGT packs to codes 0, 1, 3, 2 -> groups "00 01 11 10" LSB-first.
    from shortseq_torch import oracle

    assert tdebug.printbin(oracle.encode_bytes(b"ACGT")[0], bits=8) == \
        "00 01 11 10"


@pytest.mark.parametrize("lengths", [None, np.array([3, 32, 17])],
                         ids=["no lengths", "lengths"])
def test_dump_lanes_matches_jax(lengths):
    want = jdebug.dump_lanes(WORDS, lengths=lengths)
    assert tdebug.dump_lanes(WORDS, lengths=lengths) == want
    assert want.startswith("row 0:") and want.count("\n") == 2


def test_dump_lanes_reads_int32_tensor_as_uint32():
    """An int32 tensor with negative lanes prints as JAX's uint32 lanes;
    tensor lengths are read on the host too."""
    lanes = torch.from_numpy(WORDS.view(np.int32).copy())
    assert int(lanes.min()) < 0
    lens = np.array([3, 32, 17])
    assert tdebug.dump_lanes(lanes, lengths=torch.from_numpy(lens)) == \
        jdebug.dump_lanes(WORDS, lengths=lens)


@pytest.mark.parametrize("max_rows", [1, 2, 8])
def test_dump_lanes_truncates_like_jax(max_rows):
    mat = np.arange(40, dtype=np.uint32).reshape(20, 2)
    got = tdebug.dump_lanes(torch.from_numpy(mat.view(np.int32)),
                            max_rows=max_rows)
    assert got == jdebug.dump_lanes(mat, max_rows=max_rows)
    assert f"{20 - max_rows} more rows" in got


# --- deep_sizeof (tests/test_memory_bench.py's cases, both packages) ------

def _sizeof_cases():
    arr = np.arange(1000, dtype=np.int64)
    shared = list(range(100))
    return {"str": ("ACGT" * 8,), "bytes": (b"ACGT" * 8,), "int": (12345,),
            "array": (arr,), "view": (arr[10:500],), "views": (arr, arr[::2]),
            "shared list": ([shared, shared],),
            "nested": ({"a": [shared, "x" * 50], "b": (arr[:3], 7)},)}


@pytest.mark.parametrize("case", list(_sizeof_cases()))
def test_deep_sizeof_matches_jax(case):
    objs = _sizeof_cases()[case]
    assert tmemory.deep_sizeof(*objs) == jmemory.deep_sizeof(*objs)


def test_deep_sizeof_counts_shared_once():
    shared = list(range(100))
    assert tmemory.deep_sizeof([shared, shared]) < \
        2 * tmemory.deep_sizeof([shared])


@pytest.mark.parametrize("n_nt, size", [(16, 32), (32, 32), (33, 48),
                                        (96, 48), (97, 64), (1024, 288)])
def test_deep_sizeof_of_the_ports_objects(n_nt, size):
    """The reference's published footprints (tests/test_memory_bench.py)."""
    import shortseq_torch

    if shortseq_torch.BACKEND != "native":
        pytest.skip("exact footprints are the object extension's")
    assert tmemory.deep_sizeof(shortseq_torch.pack("A" * n_nt)) == size


# --- start_transfer_warmup ------------------------------------------------

@pytest.fixture
def warmup(monkeypatch):
    """The warmup module with no thread started yet and _warm recording
    its devices instead of touching a card."""
    seen = []
    monkeypatch.setattr(twarmup, "_thread", None)
    monkeypatch.setattr(twarmup, "_warm", seen.append)
    monkeypatch.delenv("SHORTSEQ_TORCH_NO_WARMUP", raising=False)
    return seen


def _join(thread):
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_warmup_is_idempotent(warmup):
    twarmup.start_transfer_warmup("cuda")
    first = twarmup._thread
    twarmup.start_transfer_warmup("cuda:0")
    twarmup.start_transfer_warmup()
    assert twarmup._thread is first and not first.daemon
    _join(first)
    assert warmup == [torch.device("cuda", 0)]


@pytest.mark.parametrize("device, current, want", [
    ("cuda", None, 0), ("cuda:1", None, 1), ("cuda", 1, 1),
    (torch.device("cuda", 0), 1, 0)])
def test_warmup_thread_gets_the_callers_card(monkeypatch, device, current,
                                             want):
    """The index reaches the thread resolved on the caller's thread: a
    bare "cuda" is the caller's current card once it has set one (CUDA's
    current card is per thread, and a new thread starts on card 0), and
    the thread makes that card current before its copy."""
    seen = {"context": [], "set_device": []}
    monkeypatch.setattr(twarmup, "_thread", None)
    monkeypatch.delenv("SHORTSEQ_TORCH_NO_WARMUP", raising=False)
    monkeypatch.setattr(twarmup, "_primary_context",
                        lambda i: seen["context"].append(i) or True)
    monkeypatch.setattr(torch.cuda, "is_initialized",
                        lambda: current is not None)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current)
    monkeypatch.setattr(torch.cuda, "set_device", seen["set_device"].append)
    twarmup.start_transfer_warmup(device)
    _join(twarmup._thread)
    assert seen == {"context": [want], "set_device": [want]}


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_warmup_starts_no_thread_for_the_cpu(warmup, device):
    twarmup.start_transfer_warmup(device)
    assert twarmup._thread is None and warmup == []


def test_warmup_honours_the_opt_out(warmup, monkeypatch):
    monkeypatch.setenv("SHORTSEQ_TORCH_NO_WARMUP", "1")
    twarmup.start_transfer_warmup("cuda")
    assert twarmup._thread is None and warmup == []


def test_cpu_paths_start_no_warmup(warmup, tmp_path):
    """The device engine, the UMI dedup, PackedBatch and the sharded count
    on the CPU: no thread."""
    import shortseq_torch as st
    from shortseq_torch.dist import count_fastq_sharded

    path = tmp_path / "r.fastq"
    path.write_text("@a\nACGT\n+\nIIII\n" * 3)
    st.read_and_count_fastq_table(str(path), engine="device", device="cpu")
    st.dedup_umis([b"AAAA", b"AAAT"], device="cpu")
    st.pack_batch(["ACGT"], device="cpu")
    count_fastq_sharded(str(path), device="cpu")
    assert twarmup._thread is None and warmup == []



def test_warm_needs_the_driver(monkeypatch):
    """With no CUDA driver the thread's work stops before torch touches
    the card: the caller's own first use raises where it can be handled."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    touched = []
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: touched.append(a))
    assert twarmup._primary_context(0) is False
    twarmup._warm(torch.device("cuda"))
    assert touched == []
