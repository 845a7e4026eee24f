"""Estimation paths: the `em` path judges exactly as the plain reference and
the comparison do when called directly; a path of new files only (a
configuration that names it, a traffic, a workload, the path's module and
a reader) runs through the harness and is judged by its own number; and
the harness refuses a path that is missing or incomplete, or limits that
are not the path's numbers."""

import argparse
import io
import json
import os
import shutil
from pathlib import Path

import pytest

from gpubench import harness
from gpubench.control import control_numbers
from gpubench.gen import synth
from gpubench.paths import em as em_path
from gpubench.reference import compare
from gpubench.reference.em import CONTROL, REFERENCE, reference_expression
from gpubench.tests.conftest import ROOT, SMALL
from gpubench.tests.test_gpubench_run import CELLS, _run

SEED = 2**31 + 11


def _small_cell(name):
    cell = harness.load_cell(Path(ROOT), name)
    for k, v in SMALL.items():
        (cell.traffic if k in cell.traffic else cell.config)[k] = v
    return cell


@pytest.mark.parametrize("cell", CELLS)
def test_em_checks_equal_the_direct_computation(monkeypatch, cell):
    judged = []
    real = em_path.run_sample

    def keep(inp, device, keep_values=True):
        s = real(inp, device, keep_values)
        if keep_values:
            judged.append(s)
        return s

    monkeypatch.setattr(em_path, "run_sample", keep)
    rc, line, _ = _run(cell, seed=SEED)
    assert rc == 0 and judged and line["attempted"] == len(judged)

    c = _small_cell(cell)
    ann = synth.make_annotation(c.config, c.traffic, "cpu")
    limits = c.workload["limits"]
    worst = {name: 0.0 for name in limits}
    failed = 0
    for k in sorted({s.index for s in judged}):
        raw = synth.make_sample(ann, c.config, c.traffic, SEED, k, "cpu")
        want = reference_expression(ann, raw, c.config, "cpu", REFERENCE)
        units = compare.read_units(want, ann.iso_gene, ann.n_genes)
        for s in judged:
            if s.index == k:
                g = compare.gaps(s.values, want, units)
                for name in limits:
                    worst[name] = max(worst[name], g[name])
                failed += any(not g[n] <= limits[n] for n in limits)
    assert list(line["checks"]) == list(limits)
    assert {n: v["value"] for n, v in line["checks"].items()} == worst
    assert {n: v["limit"] for n, v in line["checks"].items()} == limits
    assert line["failed"] == failed
    assert line["correct"] is (failed == 0)


def test_em_control_numbers_equal_the_direct_computation():
    c = _small_cell("tcga_bulk_em")
    got = control_numbers(c, SEED, 1, "cpu")
    ann = synth.make_annotation(c.config, c.traffic, "cpu")
    raw = synth.make_sample(ann, c.config, c.traffic, SEED, 0, "cpu")
    ctl = reference_expression(ann, raw, c.config, "cpu", CONTROL)
    ref = reference_expression(ann, raw, c.config, "cpu", REFERENCE)
    values = {"iso_count": ctl.counts, "iso_tpm": ctl.tpm,
              "iso_fpkm": ctl.fpkm, "gene_count": ctl.gene_counts,
              "gene_tpm": ctl.gene_tpm, "gene_fpkm": ctl.gene_fpkm}
    want = compare.gaps(values, ref, compare.read_units(
        ref, ann.iso_gene, ann.n_genes))
    want.update(its_rounds=ctl.rounds, reference_rounds=ref.rounds)
    assert got == {k: float(v) for k, v in want.items()}


# ---- a path of new files only -------------------------------------------
X2 = '''"""A path of a test's own: twice each isoform's alignment count."""

import time

import numpy as np

from gpubench.sut import Sample, _span

NUMBERS = ("iso_count_x2",)
OFF = 0  # added to every count the program side makes


def run_sample(inp, device, keep_values=True):
    spans = {}
    t0 = time.perf_counter()
    with _span(spans, "x2_count"):
        c = 2 * np.bincount(inp.bundle.hits.sid, minlength=inp.ref.M + 1)
    out = Sample(inp.index, time.perf_counter() - t0, spans)
    if keep_values:
        out.values = {"iso_count_x2": c + OFF}
    return out


def work(inp, sample):
    return {"hits": inp.bundle.hits.n_hits, "reads": inp.bundle.hits.n_reads,
            "isoforms": inp.ref.M, "read_len": 0, "model_rounds": 0,
            "theta_rounds": 0}


class Want:
    def __init__(self, values):
        self.values = values


def reference(ann, raw, config, device, precision):
    return Want({"iso_count_x2": 2 * np.bincount(raw.sid,
                                                 minlength=ann.M + 1)})


def gaps(values, want, ann):
    d = values["iso_count_x2"] - want.values["iso_count_x2"]
    return {"iso_count_x2": float(np.abs(d).max())}
'''

READER = '''from gpubench.readers import span_median


def read(ctx):
    return span_median(ctx, "x2_count", 1e3)
'''


def _write_cell(tmp: Path, module=None, path="x2", limits=None):
    """A benchmark of one cell in `tmp`: BENCHMARK.json there, the cell's
    files under tmp/bench; returns that directory."""
    files = tmp / "bench"
    for d in ("configs", "traffic", "workloads", "paths", "metrics"):
        (files / d).mkdir(parents=True)
    gb = Path(ROOT, "gpubench")
    cfg = json.loads((gb / "configs" / "tcga_rnaseqv2.json").read_text())
    cfg.update(name="fx_config", path=path)
    (files / "configs" / "fx_config.json").write_text(json.dumps(cfg))
    shutil.copy(gb / "traffic" / "shallow_2x50_1m.json",
                files / "traffic" / "fx_traffic.json")
    wl = {"name": "fx_cell", "config": "fx_config", "traffic": "fx_traffic",
          "chips": 1, "limits": limits or {"iso_count_x2": 0.0}}
    (files / "workloads" / "fx_cell.json").write_text(json.dumps(wl))
    if module is not None:
        (files / "paths" / f"{path}.py").write_text(module)
    for m in ("sample_s", "setup_s"):
        shutil.copy(gb / "metrics" / f"{m}.py", files / "metrics")
    (files / "metrics" / "x2_count_ms.py").write_text(READER)
    metric = {"unit": "s", "better": "lower", "bound": 0.1,
              "source": "host_clock"}
    bench = {"workloads": [{k: wl[k] for k in ("name", "config", "traffic",
                                               "chips")}],
             "end_to_end": [dict(metric, name="sample_s"),
                            dict(metric, name="setup_s"),
                            dict(metric, name="x2_count_ms", unit="ms")],
             "per_layer": []}
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return files


def _run_cell(tmp, files):
    a = argparse.Namespace(workload="fx_cell", seed=SEED, seconds=0.3,
                           trace=0, override=dict(SMALL))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(a, device="cpu", check_chip=False, root=tmp, out=out,
                     err=err, files=files)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def _repository_files():
    out = {}
    for dirpath, dirs, names in os.walk(ROOT):
        dirs[:] = [d for d in dirs if d not in
                   (".git", "__pycache__", ".pytest_cache", ".hypothesis")]
        for n in names:
            st = os.stat(os.path.join(dirpath, n))
            out[os.path.join(dirpath, n)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.mark.parametrize("off", [0, 1])
def test_a_path_of_new_files_runs_and_is_judged(tmp_path, off):
    before = _repository_files()
    files = _write_cell(tmp_path, X2.replace("OFF = 0", f"OFF = {off}"))
    rc, line, err = _run_cell(tmp_path, files)
    assert rc == 0
    # the path's stage ran in every sample: its span's reader reads it
    assert line["metrics"]["x2_count_ms"]["value"] > 0
    assert line["attempted"] >= 1
    assert line["checks"] == {"iso_count_x2": {"value": float(off),
                                               "limit": 0.0}}
    assert line["correct"] is (off == 0)
    assert line["failed"] == (line["attempted"] if off else 0)
    assert err.strip().splitlines()[-1] == (
        f"check iso_count_x2 {float(off)!r} limit 0.0")
    assert _repository_files() == before


@pytest.mark.parametrize("case", ["missing", "incomplete", "limits"])
def test_refuses_a_path_that_does_not_fit(tmp_path, case):
    if case == "missing":
        files = _write_cell(tmp_path, None, path="nowhere")
        said = "nowhere"
    elif case == "incomplete":
        files = _write_cell(tmp_path, X2.replace("def gaps(", "def gap("))
        said = "lacks gaps"
    else:
        files = _write_cell(tmp_path, X2, limits={"iso_count": 0.02})
        said = "iso_count_x2"
    rc, line, err = _run_cell(tmp_path, files)
    assert rc == 5 and line is None
    assert said in err and "no result" in err


def test_refusal_comes_before_set_up(tmp_path, monkeypatch):
    files = _write_cell(tmp_path, X2, limits={"iso_count": 0.02})

    def no_set_up(*a, **kw):
        raise AssertionError("set-up ran")

    monkeypatch.setattr(synth, "make_annotation", no_set_up)
    assert _run_cell(tmp_path, files)[0] == 5


def test_roofline_reads_the_same_with_a_paths_own_sizes():
    """Sizes of other paths (Gibbs, CI), which Work does not name, leave
    the EM's rooflines as they were."""
    from types import SimpleNamespace

    from gpubench.readers import roofline
    from gpubench.trace import Event, Trace
    from gpubench.yardstick.work import Work, model_loop, theta_loop

    w = Work(hits=10**6, reads=4 * 10**5, isoforms=1000, read_len=50,
             model_rounds=10, theta_rounds=7)._asdict()
    events = [Event("gather_sum_kernel<true>(float const*)", 0.0, 0.01)]

    def read(work, fn):
        tr = Trace(events, [], 0.02, 1, [work])
        return roofline(SimpleNamespace(trace=tr), ["gather_sum_kernel"], fn)

    wide = dict(w, genes=300, chains=8, sweeps=1200, ci_draws=50_000,
                tiles=64)
    for fn in (model_loop, theta_loop):
        assert read(wide, fn) == read(w, fn) > 0
