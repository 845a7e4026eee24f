"""The readers of the program's own instrumentation: its `rsem.` spans in
the traced samples' host trace and its counters. A traced CPU run of each
cell reports all six; a program without spans and counters (as at a
commit before them) gives the line without them; and the readers'
arithmetic on a trace written out by hand."""

import contextlib
import importlib.util
from types import SimpleNamespace

import pytest

from gpubench.program_spans import em_trees
from gpubench.tests.conftest import ROOT
from gpubench.tests.test_gpubench_run import CELLS, _run
from gpubench.trace import Event, Trace

SIX = {"upload_gb_s", "model_loop_ms", "refit_ms", "theta_round_ms",
       "host_syncs", "sync_wait_ms"}


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        name, f"{ROOT}/gpubench/metrics/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def fresh_counters():
    from rsem_tpu_torch.utils import timing

    timing.reset_counters()
    yield
    timing.reset_counters()


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_programs_metrics(cell, fresh_counters):
    rc, line, _ = _run(cell, trace=1)
    assert rc == 0 and line["correct"] is True
    got = line["metrics"]
    assert SIX <= set(got)
    assert all(got[m]["value"] > 0 for m in SIX)
    # on the CPU no copy holds the host: the syncs are the host reads, at
    # least one per theta segment and the statistics, counts and theta
    assert got["host_syncs"]["value"] >= 4
    assert got["upload_gb_s"]["unit"] == "GB/s"


def test_line_without_the_programs_spans(monkeypatch, fresh_counters):
    from rsem_tpu_torch.utils import timing

    monkeypatch.delattr(timing, "counters")
    monkeypatch.setattr(timing, "_Span",
                        lambda *_a: contextlib.nullcontext())
    rc, line, _ = _run("tcga_cells_em", trace=1)
    assert rc == 0 and line["correct"] is True
    assert not SIX & set(line["metrics"])
    assert {"em_s", "em_rounds", "model_init_ms"} <= set(line["metrics"])


def _ctx(host, work):
    return SimpleNamespace(trace=Trace([], host, 1.0, len(work), work))


MS = 1e-3
# two traced samples; an ATen op and a harness span around them are not
# the program's and are passed over
HOST = [Event("gpubench.em", 0, 200 * MS), Event("aten::copy_", 1 * MS,
                                                 2 * MS)]
SPANS = (("rsem.em", 0, 40), ("rsem.em.upload", 0, 4),
         ("rsem.em.model_loop", 4, 16), ("rsem.sync", 12, 15),
         ("rsem.em.refit", 16, 18), ("rsem.em.theta_loop", 20, 36),
         ("rsem.sync", 22, 23), ("rsem.sync", 30, 31))
for t0, scale in ((0.0, 1), (100 * MS, 2)):
    HOST += [Event(n, t0 + a * MS * scale, t0 + b * MS * scale)
             for n, a, b in SPANS]
WORK = [{"theta_rounds": 8}, {"theta_rounds": 32}]


def test_span_trees():
    trees = em_trees(_ctx(HOST, WORK))
    assert len(trees) == 2
    t = trees[0]
    assert [k.name for k in t.kids] == [
        "rsem.em.upload", "rsem.em.model_loop", "rsem.em.refit",
        "rsem.em.theta_loop"]
    assert [k.name for k in t.kids[1].kids] == ["rsem.sync"]
    assert t.kids[1].self_seconds() == pytest.approx(9 * MS)
    assert t.total("rsem.sync") == pytest.approx(5 * MS)
    assert em_trees(SimpleNamespace(trace=None)) == []


def test_readers_of_the_spans(monkeypatch):
    from rsem_tpu_torch.utils import timing

    ctx = _ctx(HOST, WORK)
    # medians of two samples: the second's ranges are twice as long
    assert _reader("model_loop_ms").read(ctx) == pytest.approx(13.5)
    assert _reader("refit_ms").read(ctx) == pytest.approx(3.0)
    assert _reader("sync_wait_ms").read(ctx) == pytest.approx(7.5)
    # 16 ms / 8 rounds and 32 ms / 32 rounds
    assert _reader("theta_round_ms").read(ctx) == pytest.approx(1.5)
    monkeypatch.setattr(timing, "counters", lambda: {
        "em_calls": 4, "upload_bytes": 4 * 6 * 10**7})
    # 60 MB over the median of 4 and 8 ms
    assert _reader("upload_gb_s").read(ctx) == pytest.approx(10.0)
    for name in SIX - {"host_syncs"}:
        assert _reader(name).read(_ctx([], WORK)) is None


def test_host_syncs_is_a_mean_per_run_em(monkeypatch):
    from rsem_tpu_torch.utils import timing

    mod = _reader("host_syncs")
    monkeypatch.setattr(timing, "counters", lambda: {})
    assert mod.read(None) is None
    monkeypatch.setattr(timing, "counters", lambda: {
        "em_calls": 4, "d2h_reads": 30, "h2d_copies": 50})
    assert mod.read(None) == 20.0
