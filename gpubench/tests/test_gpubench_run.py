"""Whole runs of the harness on the CPU at a small size: the result line's
keys, the refusal without a card, the JAX check, and that `correct` comes
out false when the timed path is broken underneath (each fault that the EM
cells can have; the exchange between chips does not exist on one card),
and when the program's model refit leaves out a step."""

import argparse
import io
import json
from pathlib import Path

import numpy as np
import pytest

from gpubench import harness, sut
from gpubench.tests.conftest import ROOT, SMALL

CELLS = ["tcga_bulk_em", "tcga_cells_em"]


def _run(cell, trace=0, seconds=0.5, seed=2**31 + 3, **kw):
    a = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                           trace=trace, override=dict(SMALL))
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(a, device="cpu", check_chip=False, root=Path(ROOT),
                     out=out, err=err, **kw)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


@pytest.mark.parametrize("cell", CELLS)
def test_line_keys_and_checks(cell):
    rc, line, err = _run(cell)
    assert rc == 0
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    names = {m["name"] for m in json.loads(
        Path(ROOT, "BENCHMARK.json").read_text())["end_to_end"]
        if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == names
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"]
        assert f"check {name} " in err
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)


def test_traced_line():
    rc, line, _ = _run("tcga_cells_em", trace=1)
    assert rc == 0
    assert "window_s" in line["device"] and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device trace: the device metrics are left out
    assert "idle_share" not in line["metrics"]
    assert {"em_s", "em_rounds", "model_init_ms"} <= set(line["metrics"])


def test_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = argparse.Namespace(workload="tcga_cells_em", seed=1, seconds=1,
                           trace=0)
    out, err = io.StringIO(), io.StringIO()
    assert harness.run(a, root=Path(ROOT), out=out, err=err) == 3
    assert out.getvalue() == ""


def test_refuses_with_jax_loaded(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    rc, line, err = _run("tcga_cells_em")
    assert rc == 4 and line is None and "jax" in err


def test_forbidden_names_compared_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "rsem_tpu_torchx", types.ModuleType("x"))
    assert "rsem_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "rsem_tpu.engine",
                        types.ModuleType("x"))
    assert "rsem_tpu" in harness.forbidden_modules()


# ---- faults in the timed path -------------------------------------------
def _state_unchanged(monkeypatch):
    """Every EM step returns the theta it was given: the fused model
    rounds (their statistics still refit the model) and every round of the
    theta loop; the final counts are taken at that theta."""
    from rsem_tpu_torch.ops import model_loop
    from rsem_tpu_torch.ops import theta as theta_ops

    real = model_loop.run_model_loop

    def model_rounds(kcfg, data, tables, theta, *a, **kw):
        _theta, suff = real(kcfg, data, tables, theta.clone(), *a, **kw)
        return theta, suff

    def rounds(state, data, n):
        for i in range(n):
            state.ring[i + 1] = state.ring[i]
            state.tot[i] = 0

    monkeypatch.setattr(model_loop, "run_model_loop", model_rounds)
    defaults = list(theta_ops.run_theta_loop.__defaults__)
    defaults[3] = rounds  # rounds_fn
    monkeypatch.setattr(theta_ops.run_theta_loop, "__defaults__",
                        tuple(defaults))


def _half_batch(monkeypatch):
    """Half of the reads left out of the EM, the counts scaled up."""
    from rsem_tpu_torch.io.hits import HitArrays
    from rsem_tpu_torch.io.reads import PairedReadArrays, ReadArrays
    from rsem_tpu_torch.io.sam import AlignmentBundle

    real = sut.run_em

    def half(model, ref, bundle, cfg, **kw):
        n = bundle.hits.n_reads // 2
        h = int(bundle.hits.read_offsets[n])
        hits = bundle.hits
        sub = HitArrays(hits.rid[:h], hits.sid[:h], hits.dir[:h],
                        hits.pos[:h], hits.insert_len[:h],
                        hits.read_offsets[:n + 1])

        def cut(m):
            return ReadArrays(m.codes[:n], m.lens[:n], m.quals[:n],
                              m.lq[:n])

        reads = PairedReadArrays.build(cut(bundle.reads.mate1),
                                       cut(bundle.reads.mate2), 25)
        cnt = type(bundle.cnt)(**{**bundle.cnt.__dict__, "N1": n})
        b = AlignmentBundle(bundle.read_type, reads, sub, bundle.stats, cnt,
                            bundle.omit)
        em = real(model, ref, b, cfg, **kw)
        em.counts = em.counts * (bundle.hits.n_reads / n)
        return em

    monkeypatch.setattr(sut, "run_em", half)


def _answer_altered(monkeypatch):
    """One read added, where the EM's counts are made, to the isoform that
    holds the fewest."""
    real = sut.run_em

    def altered(*a, **kw):
        em = real(*a, **kw)
        c = em.counts.copy()
        i = 1 + int(np.argmin(c[1:]))
        c[i] += 1.0
        em.counts = c
        return em

    monkeypatch.setattr(sut, "run_em", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    rc, line, _ = _run(cell)
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1


def _refit_skipping(monkeypatch, key):
    """The program's model refit after each model round leaves out one of
    its statistics (`gld`: the fragment lengths, `rspd`: the read starts),
    so that table keeps its starting value."""
    from rsem_tpu_torch.model import generative

    real = generative.GenerativeModel.finish_round

    def finish_round(self, suff):
        return real(self, {k: v for k, v in suff.items() if k != key})

    monkeypatch.setattr(generative.GenerativeModel, "finish_round",
                        finish_round)


# At this size the skipped read-start refit moves the cells cell's isoforms
# by up to 0.15 of its 0.3 limit; the bulk cell's 0.02 catches it.
@pytest.mark.parametrize("cell,key", [("tcga_bulk_em", "gld"),
                                      ("tcga_cells_em", "gld"),
                                      ("tcga_bulk_em", "rspd")])
def test_refit_step_left_out_is_not_correct(monkeypatch, cell, key):
    _refit_skipping(monkeypatch, key)
    rc, line, _ = _run(cell)
    assert rc == 0
    assert line["correct"] is False and line["failed"] >= 1
