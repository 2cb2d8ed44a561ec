"""shortseq_torch's profiler ranges are wired into its kernels' wrappers,
under the names the JAX package's jax.named_scope gives them
(tests/test_profiling_wired.py pins those in the lowered HLO), and into
the FASTQ count path's host stages (tests/test_torch_spans.py checks
their tree): under torch.profiler every wrapper's call shows its ssq.*
range, on either route (here the plain versions on the CPU; on the card
chip_smoke checks that each kernel's launch falls inside its range).
With no profiler active named_scope records nothing, and it never
swallows the block's exception.  utils.trace writes a Chrome/TensorBoard
trace file."""

import gzip
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from shortseq_torch.utils import named_scope, trace


def _rows():
    """[6, 2] packed words, their lengths and unit weights (CPU)."""
    from shortseq_torch.ops.bitpack import pack_words_u32

    rng = np.random.default_rng(3)
    ascii_u8 = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (6, 32))]
    lanes = torch.from_numpy(ascii_u8.copy()).view(torch.int32)
    return lanes, pack_words_u32(lanes), torch.full((6,), 32,
                                                    dtype=torch.int32)


def _call(scope, tmp_path):
    import shortseq_torch as st
    from shortseq_torch.api.counter import table_to_counter
    from shortseq_torch.count import CountTable
    from shortseq_torch.count.checkpoint import merge_host_tuples
    from shortseq_torch.count.device import unique_count
    from shortseq_torch.dist import count as dc
    from shortseq_torch.dist import data_mesh
    from shortseq_torch.ops import bitpack, hamming

    lanes, words, lens = _rows()
    ones = torch.ones(6, dtype=torch.int32)
    mesh = data_mesh(device="cpu")
    fastq = tmp_path / "reads.fastq"
    fastq.write_text("@a\nACGT\n+\nIIII\n" * 3 + "@b\nGG\n+\nII\n")

    def count():
        return st.read_and_count_fastq_table(str(fastq), engine="device",
                                             device="cpu")

    host = (words.numpy().view(np.uint32), lens.numpy(), ones.numpy())
    return {
        "ssq.pack_validate": lambda: bitpack.pack_and_validate_u32(lanes,
                                                                   lens),
        "ssq.pack": lambda: bitpack.pack_words_u32(lanes),
        "ssq.unpack": lambda: bitpack.unpack_ascii(words),
        "ssq.hamming_rows": lambda: hamming.hamming_rows(words, words),
        "ssq.pairwise_jnp": lambda: hamming.hamming_pairwise(words, words),
        "ssq.pairwise_mxu": lambda: hamming.hamming_pairwise_onehot(words,
                                                                    words),
        "ssq.unique_count": lambda: unique_count(words, lens, ones),
        "ssq.merge_allgather": lambda: dc.count_sharded(mesh)(words, lens,
                                                              ones),
        "ssq.bucket_exchange": lambda: dc.count_sharded_bucketed(mesh)(
            words, lens, ones),
        **dict.fromkeys(("ssq.read_count", "ssq.file_read", "ssq.index",
                         "ssq.gather_pack", "ssq.h2d", "ssq.d2h"), count),
        "ssq.merge": lambda: merge_host_tuples([host, host], device="cpu"),
        **dict.fromkeys(("ssq.to_counter", "ssq.objects"),
                        lambda: table_to_counter(unique_count(words, lens,
                                                              ones))),
        "ssq.table_read": lambda: CountTable.from_device_tables(
            [unique_count(words, lens, ones)]).total(),
    }[scope]


#: The ranges one whole-file call of a one-bucket FASTQ enters, in order.
COUNT_PATH = ["ssq.read_count", "ssq.file_read", "ssq.index",
              "ssq.gather_pack", "ssq.h2d", "ssq.h2d", "ssq.unique_count",
              "ssq.d2h"]


SCOPES = ["ssq.pack_validate", "ssq.pack", "ssq.unpack", "ssq.hamming_rows",
          "ssq.pairwise_jnp", "ssq.pairwise_mxu", "ssq.unique_count",
          "ssq.merge_allgather", "ssq.bucket_exchange",
          # the count path's host stages (utils/profiling.py)
          "ssq.read_count", "ssq.file_read", "ssq.index", "ssq.gather_pack",
          "ssq.h2d", "ssq.d2h", "ssq.merge", "ssq.to_counter",
          "ssq.objects", "ssq.table_read"]


@pytest.mark.parametrize("scope", SCOPES)
def test_scope_shows_under_the_profiler(scope, tmp_path):
    fn = _call(scope, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    names = {e.key for e in prof.key_averages()}
    assert scope in names
    assert not {s for s in names if s.startswith("ssq.")} - set(SCOPES)


def test_no_profiler_records_nothing(monkeypatch, tmp_path):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    calls = {scope: _call(scope, tmp_path) for scope in SCOPES}
    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    for fn in calls.values():
        fn()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        calls["ssq.unique_count"]()
    assert entered == ["ssq.unique_count"]
    entered.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        calls["ssq.read_count"]()
    assert entered == COUNT_PATH


@pytest.mark.parametrize("profiled", [False, True])
def test_scope_reraises_the_blocks_exception(profiled):
    class Boom(ImportError):
        pass

    def run():
        with pytest.raises(Boom):
            with named_scope("ssq.test"):
                raise Boom("from the block")

    if not profiled:
        run()
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
        with named_scope("ssq.after"):
            pass
    names = [e.key for e in prof.key_averages()]
    assert "ssq.test" in names and "ssq.after" in names


def test_trace_writes_a_trace_file(tmp_path):
    from shortseq_torch.count.device import unique_count

    _, words, lens = _rows()
    with trace(tmp_path) as prof:
        unique_count(words, lens, torch.ones(6, dtype=torch.int32))
    assert prof is not None
    files = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert len(files) == 1 and ".pt.trace.json" in files[0].name
    raw = files[0].read_bytes()
    if files[0].suffix == ".gz":
        raw = gzip.decompress(raw)
    events = json.loads(raw)["traceEvents"]
    assert any(e.get("name") == "ssq.unique_count" for e in events)


@pytest.mark.parametrize("scope", SCOPES[:7])
def test_scoped_wrappers_keep_their_surface(scope):
    """The seven wrappers that `scoped` decorates keep their name,
    docstring and launch counter (chip_smoke resets and reads it), and
    expose the undecorated function as __wrapped__."""
    from shortseq_torch.count import device
    from shortseq_torch.ops import bitpack, hamming

    fn = {"ssq.pack_validate": bitpack.pack_and_validate_u32,
          "ssq.pack": bitpack.pack_words_u32,
          "ssq.unpack": bitpack.unpack_ascii,
          "ssq.hamming_rows": hamming.hamming_rows,
          "ssq.pairwise_jnp": hamming.hamming_pairwise,
          "ssq.pairwise_mxu": hamming.hamming_pairwise_onehot,
          "ssq.unique_count": device.unique_count}[scope]
    assert fn.__wrapped__.__name__ == fn.__name__ and fn.__doc__
    assert fn.__wrapped__.__doc__ == fn.__doc__
    if fn.__name__ in ("pack_and_validate_u32", "pack_words_u32",
                       "unpack_ascii", "hamming_rows"):
        assert fn.launches >= 0
