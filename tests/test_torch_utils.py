"""shortseq_torch.utils and shortseq_torch.config against shortseq_tpu's:
the phase timer (tests/test_utils.py's cases) and the pipeline
configuration."""

import dataclasses
import re

import pytest

import shortseq_torch.utils.profiling as tutils
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
