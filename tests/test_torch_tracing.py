"""The port's instrumentation (utils/timing.py) around run_em on the CPU:
the counters of the host/device boundary, the EM's spans in memory and on
the profiler's clock, the shared null context when nothing listens, and
the --time file's span lines."""

import copy
import gzip
import os
import shutil
import warnings

import numpy as np
import pytest
import torch

from rsem_tpu_torch.engine import em as tem
from rsem_tpu_torch.ops import layout
from rsem_tpu_torch.ops import theta as theta_ops
from rsem_tpu_torch.testing import synthetic_dataset
from rsem_tpu_torch.utils import device, timing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "goldens")

EM_CHILDREN = ["rsem.em.setup", "rsem.em.upload", "rsem.em.model_loop",
               "rsem.em.refit", "rsem.em.final_conprbs",
               "rsem.em.theta_loop", "rsem.em.counts", "rsem.em.finish"]
MODEL_ROUNDS = tem.EMConfig().update_model_rounds


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=[False, True], ids=["se", "pe"])
def data(request):
    ref, bundle, _spec, model = synthetic_dataset(
        n_reads=600, M=30, read_len=36, tx_len=300, paired=request.param,
        has_qual=True, mean_extra_hits=1.0, seed=11)
    return ref, bundle, model


def _run(data, posteriors=False, **cfg):
    ref, bundle, model = data
    return tem.run_em(copy.deepcopy(model), ref, bundle, tem.EMConfig(**cfg),
                      need_posteriors=posteriors, device="cpu")


def _layout_arrays(ref, bundle):
    reads = ([bundle.reads.mate1, bundle.reads.mate2]
             if hasattr(bundle.reads, "mate1") else [bundle.reads])
    h = bundle.hits
    arrays = [ref.codes, ref.offsets, ref.full_len, ref.tot_len,
              ref.mask_start]
    for r in reads:
        arrays += [r.codes, r.lens, r.quals, r.lq]
    arrays += [h.rid, h.sid, h.dir, h.pos, h.insert_len, h.read_offsets]
    return [a for a in arrays if a is not None]


def _segments(rounds: int):
    """(segments, rounds enqueued) of the theta loop to a stop at
    `rounds`, replaying its segment rule."""
    r, segs, enq = MODEL_ROUNDS, 0, 0
    cfg = tem.EMConfig()
    while True:
        n = theta_ops._segment_length(r, cfg.min_round, cfg.max_round,
                                      theta_ops.SEGMENT)
        segs, enq = segs + 1, enq + n
        if rounds <= r + n:
            return segs, enq
        r += n


@pytest.fixture
def as_on_a_card(monkeypatch):
    """Counts the copies to the device as a CUDA device makes the host
    wait for them (the CPU does not)."""
    monkeypatch.setattr(device, "copy_waits", lambda _dev: True)


@pytest.mark.parametrize("posteriors", [False, True])
def test_counters_of_one_run(data, posteriors, as_on_a_card):
    """d2h_reads: one per theta segment, the statistics' read, the counts
    and theta (and the four posterior arrays); h2d: the layout, the
    model's tables before and after the refit, theta, and the fused
    loop's noise counts and n0; upload_bytes: the layout's host bytes."""
    ref, bundle, model = data
    timing.reset_counters()
    res = _run(data, posteriors)
    c = timing.counters()
    segs, enq = _segments(res.rounds)
    assert enq >= res.rounds - MODEL_ROUNDS
    assert c["em_calls"] == 1
    assert c["d2h_reads"] == segs + 3 + (4 if posteriors else 0)
    arrays = _layout_arrays(ref, bundle)
    assert c["upload_bytes"] == sum(np.asarray(a).nbytes for a in arrays)
    n_model = len(model.device_arrays())
    assert c["h2d_copies"] == len(arrays) + 2 * n_model + 3


def test_copies_counted_where_the_host_waits(data):
    """A copy from numpy memory holds the host on a CUDA device only: on
    the CPU, run_em counts its reads and no copy."""
    assert device.copy_waits("cuda") and device.copy_waits("cuda:1")
    assert not device.copy_waits("cpu") and not device.copy_waits("meta")
    timing.reset_counters()
    device.to_device(np.zeros(3), "cpu")
    assert "h2d_copies" not in timing.counters()
    _run(data)
    c = timing.counters()
    assert "h2d_copies" not in c and c["d2h_reads"] > 0


@pytest.mark.cuda
def test_card_waits_are_the_counted_ones(data):
    """On the card, every operation that PyTorch's sync debug mode reports
    as synchronising lies in utils/device's counted helpers, and run_em
    counts the copies and reads the CPU counts for it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ref, bundle, model = data
    layout.clear_device_cache()
    timing.reset_counters()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = tem.run_em(copy.deepcopy(model), ref, bundle,
                             tem.EMConfig(), need_posteriors=False,
                             device="cuda")
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            layout.clear_device_cache()
    c = timing.counters()
    at = {os.path.abspath(w.filename) for w in seen
          if "called a synchronizing" in str(w.message)}
    assert at == {os.path.abspath(device.__file__)}
    segs, _ = _segments(res.rounds)
    assert c["d2h_reads"] == segs + 3
    n_model = len(model.device_arrays())
    assert c["h2d_copies"] == len(_layout_arrays(ref, bundle)) \
        + 2 * n_model + 3


def test_counters_of_the_per_round_path(data, as_on_a_card):
    """Without the fused loop each model round reads its theta and its
    statistics, and uploads log theta and the refit tables."""
    ref, bundle, model = data
    timing.reset_counters()
    res = _run(data, fused_model=False)
    c = timing.counters()
    segs, _ = _segments(res.rounds)
    assert c["d2h_reads"] == 2 * MODEL_ROUNDS + segs + 2
    n_model = len(model.device_arrays())
    assert c["h2d_copies"] == (len(_layout_arrays(ref, bundle))
                               + (MODEL_ROUNDS + 1) * n_model
                               + MODEL_ROUNDS + 1)


def test_upload_bytes_not_counted_when_cached(data):
    """A layout the device cache serves copies nothing. The CPU is never
    cached, so the cache runs on the meta device here."""
    ref, bundle, model = data
    meta = torch.device("meta")
    layout.clear_device_cache()
    try:
        timing.reset_counters()
        tem.upload(ref, bundle, model.spec.paired, meta)
        first = timing.counters()
        tem.upload(ref, bundle, model.spec.paired, meta)
        second = timing.counters()
    finally:
        layout.clear_device_cache()
    want = sum(np.asarray(a).nbytes for a in _layout_arrays(ref, bundle))
    assert first["upload_bytes"] == want
    assert second == first


@pytest.mark.parametrize("fused", [True, False])
def test_em_spans_nested_in_order(data, fused):
    """One rsem.em span; its children are the eight phases in order (the
    per-round path nests a refit in every model round instead), every
    host read is an rsem.sync inside one of them, and the children leave
    under 5% of rsem.em as its self time."""
    with timing.tracing() as spans:
        res = _run(data, fused_model=fused)
    tops = [i for i, s in enumerate(spans) if s.parent == -1]
    assert [spans[i].name for i in tops] == ["rsem.em"]
    root = tops[0]
    kids = [s.name for s in spans if s.parent == root]
    want = EM_CHILDREN if fused else [n for n in EM_CHILDREN
                                      if n != "rsem.em.refit"]
    assert kids == want
    for i, s in enumerate(spans):
        assert s.start <= s.end
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    loop = next(i for i, s in enumerate(spans)
                if s.name == "rsem.em.model_loop")
    refits = [s for s in spans if s.name == "rsem.em.refit"]
    assert len(refits) == (1 if fused else MODEL_ROUNDS)
    assert all(s.parent == (root if fused else loop) for s in refits)
    syncs = [s for s in spans if s.name == "rsem.sync"]
    segs, _ = _segments(res.rounds)
    assert len(syncs) == (segs + 3 if fused else
                          2 * MODEL_ROUNDS + segs + 2)
    assert all(spans[s.parent].name.startswith("rsem.em.") for s in syncs)
    covered = sum(s.seconds for s in spans if s.parent == root)
    assert spans[root].seconds - covered < 0.05 * spans[root].seconds


def test_profiler_carries_the_spans(data):
    """Under torch.profiler the same names are host ranges of the trace,
    and nothing is recorded in memory."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(data)
    names = {e.key for e in prof.key_averages()}
    assert {"rsem.em", "rsem.sync", *EM_CHILDREN} <= names
    assert timing._rec is None


def test_nothing_listens(data, monkeypatch):
    """With neither tracing() nor a profiler on, span() hands out one
    shared null context and never enters record_function."""
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert timing.span("a") is timing.span("b") is timing._NULL
    res = _run(data)
    assert res.rounds > MODEL_ROUNDS
    with timing.tracing() as spans:
        pass
    assert spans == [] and timing._rec is None


def test_results_identical_with_tracing(data):
    plain = _run(data, posteriors=True)
    with timing.tracing():
        traced = _run(data, posteriors=True)
    assert traced.rounds == plain.rounds
    for k in ("theta_raw", "counts", "tpm", "fpkm", "frac_hit",
              "log_conprb"):
        np.testing.assert_array_equal(getattr(traced, k), getattr(plain, k))


def test_span_totals_and_nesting():
    spans = [timing.Span("a", -1, 0, 100), timing.Span("b", 0, 10, 40),
             timing.Span("b", 0, 50, 70), timing.Span("c", 1, 20, 30)]
    assert timing.span_totals(spans) == pytest.approx(
        {"a": 100e-9, "b": 50e-9, "c": 10e-9})
    with timing.tracing() as outer:
        with timing.span("x"):
            with timing.tracing() as inner:
                with timing.span("y"):
                    pass
            with timing.span("z"):
                pass
    assert [(s.name, s.parent) for s in outer] == [("x", -1), ("z", 0)]
    assert [(s.name, s.parent) for s in inner] == [("y", -1)]


def test_time_file_has_em_spans(tmp_path, monkeypatch):
    """calculate-expression --time: the headline lines as before, then one
    comment line per stage, the EM's phases after the em stage."""
    from rsem_tpu_torch.pipeline.calculate_expression import main

    for ext in ("seq", "ti", "grp"):
        shutil.copy(os.path.join(GOLD, f"ref.{ext}"), tmp_path)
    with gzip.open(os.path.join(GOLD, "aln.sam.gz"), "rb") as f:
        (tmp_path / "aln.sam").write_bytes(f.read())
    monkeypatch.chdir(tmp_path)
    assert main(["--alignments", "aln.sam", "ref", "out", "-q",
                 "--device", "cpu", "--no-bam-output", "--time"]) == 0
    lines = (tmp_path / "out.time").read_text().splitlines()
    assert lines[0].startswith("Aligning reads: ")
    assert lines[1].startswith("Estimating expression levels: ")
    assert lines[2].startswith("Calculating credibility intervals: ")
    names = [ln[2:].split(":")[0] for ln in lines[3:]]
    i = names.index("em")
    assert names[i + 1:i + 9] == [n[len("rsem."):] for n in EM_CHILDREN]
    est = float(lines[1].split(": ")[1].split()[0])
    stage = {n: float(ln.split(": ")[1].split()[0])
             for n, ln in zip(names, lines[3:])}
    assert est == pytest.approx(stage["parse-alignments"] + stage["em"],
                                abs=0.011)
