"""Variants of the Gibbs sweep's inputs (K5), from the CPU.

The card's check of K5 at a human-transcriptome table size sweeps a layout
whose sids are relabelled s -> 10 s in a table widened to T = 10 M + 1;
here the plain sweep shows that such a layout samples exactly as the
original does. Also the delta scratch that a run allocates once and passes
to every sweep: its checks, and that run_chains owns one per run."""

import pytest
import torch

from rsem_tpu_torch.engine import gibbs as engine
from rsem_tpu_torch.ops import gibbs
from rsem_tpu_torch.testing import relabel_layout, synthetic_gibbs_hits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small ops; in a test run of several
    worker processes torch's intra-op thread pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chains(N=40, M=12, C=2):
    hits, lcp, lnp = synthetic_gibbs_hits(N, M, seed=0, max_hits=2)
    layout = gibbs.build_layout(hits, lcp, lnp, M)
    assigns, tab = gibbs.init_chains(layout, torch.ones(M + 1), C, seed=1)
    return layout, assigns, tab


@pytest.mark.parametrize("K", [1, 2, 8, 64, 256])
def test_relabelled_layout_sweeps_like_the_original(K):
    M = 300 if K > 1 else 2000
    N = {1: 9000, 2: 5000, 8: 2500, 64: 300, 256: 70}[K]
    hits, lcp, lnp = synthetic_gibbs_hits(N, M, seed=K, max_hits=K,
                                          min_hits=K // 2 + 1)
    lnp[::3] = -20.0  # noise competes with the hits of a third of the reads
    layout = gibbs.build_layout(hits, lcp, lnp, M)
    assert {p.K for p in layout.parts} == {K}
    base = torch.full((M + 1,), 0.1)
    base[0] += 5.0
    assigns, tab = gibbs.init_chains(layout, base, 3, seed=2)
    big_layout, big = relabel_layout(layout, tab)
    assert big.shape == (3, 10 * M + 1)
    assert [(p.K, p.n_tiles, p.n_real) for p in big_layout.parts] == [
        (p.K, p.n_tiles, p.n_real) for p in layout.parts]
    a_big = [a.clone() for a in assigns]
    start = assigns[0].clone()
    for sweep in range(2):
        for pi, (part, bpart) in enumerate(zip(layout.parts,
                                               big_layout.parts)):
            sp = gibbs.part_seed(4, pi)
            gibbs.sweep_part(assigns[pi], tab, part, sp, sweep)
            gibbs.sweep_part(a_big[pi], big, bpart, sp, sweep)
    for a, b in zip(assigns, a_big):
        assert torch.equal(a, b)
    assert torch.equal(big[:, ::10], tab)
    untouched = torch.ones_like(big, dtype=torch.bool)
    untouched[:, ::10] = False
    assert bool((big[untouched] == 1.0).all())
    assert int((assigns[0] != start).sum()) > 0  # reads moved


@pytest.mark.parametrize("factor", [1, 3, 40])
def test_relabel_layout_keeps_the_tiles(factor):
    layout, _a, tab = _chains()
    big_layout, big = relabel_layout(layout, tab, factor=factor)
    assert big_layout.M == factor * layout.M
    assert (big_layout.n_reads, big_layout.n_noise_fixed) == (
        layout.n_reads, layout.n_noise_fixed)
    for p, b in zip(layout.parts, big_layout.parts):
        assert torch.equal(b.sid, p.sid * factor)
        assert b.cps is p.cps and b.ncs is p.ncs
        assert (b.K, b.n_tiles, b.n_real) == (p.K, p.n_tiles, p.n_real)
    assert big.shape == (tab.shape[0], factor * (tab.shape[1] - 1) + 1)
    assert torch.equal(big[:, ::factor], tab)
    assert float(big.sum()) == pytest.approx(
        float(tab.sum()) + big.numel() - tab.numel())


@pytest.mark.parametrize("bad", ["dtype", "shape", "strided", "device"])
def test_sweep_part_checks_the_delta_scratch(bad):
    layout, assigns, tab = _chains()
    C, T = tab.shape
    scratch = {
        "dtype": torch.zeros((C, T), dtype=torch.int64),
        "shape": torch.zeros((C, T + 1), dtype=torch.int32),
        "strided": torch.zeros((T, C), dtype=torch.int32).t(),
        "device": torch.zeros((C, T), dtype=torch.int32, device="meta"),
    }[bad]
    tab0, a0 = tab.clone(), assigns[0].clone()
    with pytest.raises(ValueError, match="scratch"):
        gibbs.sweep_part(assigns[0], tab, layout.parts[0], 1, 0, scratch)
    assert torch.equal(tab, tab0) and torch.equal(assigns[0], a0)


def test_sweep_part_with_a_scratch_sweeps_as_without():
    """On CPU tensors the plain version runs and the scratch stays zero."""
    layout, assigns, tab = _chains(N=400, M=30, C=3)
    a2, tab2 = [a.clone() for a in assigns], tab.clone()
    scratch = gibbs.delta_scratch(tab)
    assert scratch.dtype == torch.int32 and scratch.shape == tab.shape
    for sweep in range(2):
        for pi, part in enumerate(layout.parts):
            sp = gibbs.part_seed(2, pi)
            gibbs.sweep_part(assigns[pi], tab, part, sp, sweep, scratch)
            gibbs.sweep_part(a2[pi], tab2, part, sp, sweep)
    assert all(torch.equal(a, b) for a, b in zip(assigns, a2))
    assert torch.equal(tab, tab2)
    assert not bool(scratch.any())


def test_run_chains_passes_one_scratch_to_every_sweep(monkeypatch):
    layout, assigns, tab = _chains(N=200, M=20, C=2)
    seen = []

    def record(a, table, part, sp, s, scratch=None, chain0=0):
        seen.append(scratch)
        return gibbs.sweep_part(a, table, part, sp, s, scratch, chain0)

    monkeypatch.setattr(engine, "sweep_part", record)
    cfg = engine.GibbsConfig(burnin=2, nsamples=4, gap=1, n_chains=2)
    cvs = engine.run_chains(layout, assigns, tab, torch.ones(21), cfg)
    assert cvs.shape == (2, 2, 21)
    assert len(seen) == 4 * len(layout.parts)
    assert seen[0] is not None and seen[0].shape == tab.shape
    assert all(s is seen[0] for s in seen)
