"""pRSEM in the port (rsem_tpu_torch.prsem, calculate-expression
--run-pRSEM, run-prsem-testing-procedure) against the JAX package on the
same seeded inputs: the training-set filters (sorted sweeps in the port,
nested loops in the JAX package) and the GC fractions identical, the 15
partition models and the Dirichlet-multinomial fit, learn_prior's files
byte for byte given the same posterior mean counts, the ChIP-seq leg, and
the driver end to end on tests/test_prsem.py's fixture.

The JAX driver runs its Gibbs stage on one device with its CPU default,
the XLA blocked sweep, whose staleness bound (~N1/n_blocks reads) the
port's dealt tile layout keeps, its one-hot count refresh in small blocks
(test_torch_allele.xla_gibbs), as tests/test_torch_allele.py does."""

import contextlib
import io
import os
import shutil
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import rsem_tpu.prsem as jprsem
import rsem_tpu_torch.prsem as pprsem
from rsem_tpu.pipeline.calculate_expression import main as jax_calc
from rsem_tpu.pipeline.prepare_reference import main as jax_prep
from rsem_tpu.prsem import chipseq as jchip
from rsem_tpu.prsem import runner as jrunner
from rsem_tpu.prsem import training as jtraining
from rsem_tpu.refprep.reference import Reference as JReference
from rsem_tpu.refprep.transcripts import Transcripts as JTranscripts
from rsem_tpu_torch.__main__ import main as port_cli
from rsem_tpu_torch.prsem import chipseq as pchip
from rsem_tpu_torch.prsem import runner as prunner
from rsem_tpu_torch.prsem import training as ptraining
from rsem_tpu_torch.refprep.reference import Reference as PReference
from rsem_tpu_torch.refprep.transcripts import Transcripts as PTranscripts

from test_chipseq_groundtruth import FRAGLEN, _simulate_reads
from test_prsem import (
    _make_chipseq_tagalign,
    _make_genome_and_gtf,
    _reads_sam,
)
from test_prsem_partition import _synthetic_features
from test_torch_allele import xla_gibbs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIBBS = ["--calc-pme", "--seed", "13", "--gibbs-chains", "2",
         "--gibbs-burnin", "20", "--gibbs-number-of-samples", "80"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- #
# training set and GC fraction                                           #
# --------------------------------------------------------------------- #
def _random_spans(rng, n=150):
    """(gene, trid, chrom, exons) rows on three chromosomes of a 20 kb
    grid: shared starts and ends, spans nested in others, exons copied from
    other transcripts and a few repeated ids. Each transcript's own exons
    are sorted and disjoint, as prepare-reference --gtf leaves them."""
    rows = []
    for k in range(n):
        chrom = f"chr{rng.integers(1, 4)}"
        gene = f"g{k // 2 if rng.random() < 0.3 else k + 1000}"
        trid = f"t{k}"
        if rows and rng.random() < 0.04:
            _g, trid, chrom, _e = rows[int(rng.integers(len(rows)))]
        if rows and rng.random() < 0.2:
            src = rows[int(rng.integers(len(rows)))]
            chrom = src[2]
            if rng.random() < 0.5:  # equal exons
                exons = list(src[3])
            else:  # a span nested in the source's
                s, e = src[3][0][0], src[3][-1][1]
                a = int(rng.integers(s, (s + e) // 2 + 1))
                exons = [(a, int(rng.integers(a, e + 1)))]
        else:
            s = int(rng.integers(0, 400)) * 50 + 1
            cuts = np.sort(rng.choice(np.arange(1, 60), size=2 * int(
                rng.integers(1, 4)), replace=False)) * 50
            exons = [(s + int(cuts[i]), s + int(cuts[i + 1]) - 1)
                     for i in range(0, len(cuts), 2)]
        rows.append((gene, trid, chrom, exons))
    return rows


def _coords(pkg, rows, rng):
    strands = rng.random(len(rows)) < 0.5
    return [pkg.TrCoord(gene_id=g, trid=t, chrom=c,
                        strand="+" if st else "-", start=ex[0][0],
                        end=ex[-1][1], exons=list(ex))
            for (g, t, c, ex), st in zip(rows, strands)]


@pytest.mark.parametrize("seed", range(4))
def test_training_filters_match_jax(seed):
    """_nested_within_other and _exons_all_covered on every transcript,
    and select_training_set at the default and at looser settings: the
    same index sets as the JAX package's loops."""
    rows = _random_spans(np.random.default_rng(seed))
    jc = _coords(jprsem, rows, np.random.default_rng(100 + seed))
    pc = _coords(pprsem, rows, np.random.default_rng(100 + seed))
    every = list(range(len(rows)))
    nested = jtraining._nested_within_other(jc, every)
    covered = jtraining._exons_all_covered(jc, every)
    assert ptraining._nested_within_other(pc, every) == nested
    assert ptraining._exons_all_covered(pc, every) == covered
    assert 0 < len(nested) < len(rows) and 0 < len(covered) < len(rows)
    for kw in ({}, dict(min_gene_len=200, flanking_width=100)):
        want = jprsem.select_training_set(jc, jprsem.Mappability(None), **kw)
        got = pprsem.select_training_set(pc, pprsem.Mappability(None), **kw)
        assert got == want
    assert want


def test_exons_all_covered_refuses_overlapping_exons():
    """A transcript whose own exons overlap, which prepare-reference --gtf
    never writes, is refused rather than swept."""
    rows = [("g1", "t1", "chr1", [(1, 300), (200, 400)]),
            ("g2", "t2", "chr1", [(1, 500)])]
    pc = _coords(pprsem, rows, np.random.default_rng(0))
    with pytest.raises(ValueError, match="t1 has overlapping"):
        ptraining._exons_all_covered(pc, [0, 1])


def test_gc_fraction_matches_jax():
    """Counted over the base codes at once: the JAX package's floats,
    bit for bit; with poly(A) tails the tail is left out."""
    rng = np.random.default_rng(5)
    M = 40
    seqs = ["".join(rng.choice(list("ACGTNacgt"), size=int(n)))
            for n in rng.integers(1, 300, M)]
    names = [f"t{i}" for i in range(M)]
    ts = SimpleNamespace(M=M)
    want = jrunner._gc_fraction(JReference(names, seqs, [0] * M), ts)
    got = prunner._gc_fraction(PReference(names, seqs, [0] * M), ts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    tails = [int(x) for x in rng.integers(0, 30, M)]
    got = prunner._gc_fraction(PReference(names, seqs, tails), ts)
    assert np.array_equal(got, [sum(b in "GCgc" for b in s) / len(s)
                                for s in seqs])


# --------------------------------------------------------------------- #
# partition models and the Dirichlet-multinomial fit                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("model", jprsem.PARTITION_MODELS)
def test_partition_and_fit_match_jax(model):
    jf = _synthetic_features()
    pf = pprsem.TranscriptFeatures(**vars(_synthetic_features()))
    jp = jprsem.compute_partition(model, jf)
    pp = pprsem.compute_partition(model, pf)
    assert pp.n_parts == jp.n_parts
    assert np.array_equal(pp.partition, jp.partition)
    assert np.array_equal(pp.trn_partition, jp.trn_partition)
    trn = jf.is_training.astype(bool)
    ja, jl = jprsem.fit_partitioned_dm(jf.pme_count[trn], jp.trn_partition,
                                       jp.n_parts)
    pa, pl = pprsem.fit_partitioned_dm(pf.pme_count[trn], pp.trn_partition,
                                       pp.n_parts)
    np.testing.assert_allclose(pa, ja, rtol=1e-12)
    np.testing.assert_allclose(pl, jl, rtol=1e-12)


# --------------------------------------------------------------------- #
# the ChIP-seq leg                                                       #
# --------------------------------------------------------------------- #
def test_chipseq_leg_matches_jax(tmp_path):
    """Fragment length, pooled and replicate peak calls, reproducible
    peaks and the written peak file: equal to the JAX package's."""
    rng = np.random.default_rng(3)
    reps = [_simulate_reads(rng, n_background=4000, per_peak=700)
            for _ in range(2)]
    control = _simulate_reads(rng, n_background=8000, per_peak=0)
    pooled = {"chr1": tuple(np.concatenate([r["chr1"][i] for r in reps])
                            for i in range(3))}
    fl = pchip.estimate_fragment_length(pooled)
    assert fl == jchip.estimate_fragment_length(pooled)
    assert abs(fl - FRAGLEN) <= 20
    calls = {}
    for name, mod in (("jax", jchip), ("port", pchip)):
        pool = mod.call_peaks(pooled, control, fraglen=fl)
        per_rep = [mod.call_peaks(r, control, fraglen=fl).peaks
                   for r in reps]
        final = mod.reproducible_peaks(pool.peaks, per_rep)
        mod.write_peaks(final, str(tmp_path / f"{name}.regionPeak.gz"))
        calls[name] = (pool, per_rep, final)
    (jpool, jrep, jfinal), (ppool, prep, pfinal) = calls["jax"], \
        calls["port"]
    assert (ppool.fraglen, ppool.n_target) == (jpool.fraglen,
                                               jpool.n_target)
    for got, want in [(ppool.peaks, jpool.peaks), (pfinal, jfinal)] + list(
            zip(prep, jrep)):
        assert sorted(got) == sorted(want)
        for ch in want:
            assert np.array_equal(got[ch], want[ch]), ch
    assert len(jfinal["chr1"])
    assert pprsem.read_peaks(str(tmp_path / "port.regionPeak.gz")).keys() \
        == jprsem.read_peaks(str(tmp_path / "jax.regionPeak.gz")).keys()


# --------------------------------------------------------------------- #
# learn_prior given the same posterior mean counts                       #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def prsem_ref(tmp_path_factory):
    """tests/test_prsem.py's genome reference, peaks and ChIP-seq
    replicates, prepared by the JAX package."""
    d = tmp_path_factory.mktemp("prsem_ref")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        genome, genes = _make_genome_and_gtf(d)
        _reads_sam(genome, genes, d)
        _make_chipseq_tagalign(d, genes)
        assert jax_prep(["--gtf", "anno.gtf", "genome.fa", "gref",
                         "-q"]) == 0
    return d, genes


LEARN_CASES = {
    "pk": dict(chipseq_peak_file="peaks.bed"),
    "lm4": dict(chipseq_target_read_files=[
        "chip_rep1.tagAlign.gz", "chip_rep2.tagAlign.gz"]),
    "cmb_lgt": dict(chipseq_bed_files_multi_targets=[
        "chip_rep1.tagAlign.gz", "chip_rep2.tagAlign.gz"],
        cap_stacked_chipseq_reads=True),
}


@pytest.mark.parametrize("model", sorted(LEARN_CASES))
def test_learn_prior_files_identical(prsem_ref, model, monkeypatch):
    """The same pme_count through both packages' learn_prior: prior,
    p-value and log-likelihood equal; .all_tr_features, .training_tr_crd,
    .all_tr_prior and .pval_LL byte-identical (lm4 runs the ChIP-seq leg
    on the tagAlign replicates, cmb_lgt the multi-target signals)."""
    d, genes = prsem_ref
    monkeypatch.chdir(d)
    rng = np.random.default_rng(11)
    pme = np.round(rng.lognormal(2.0, 1.5, len(genes)), 2)
    pme[: len(genes) // 2] *= 8  # the peak genes
    pme[-5:] = 0.0  # not expressed (cmb_lgt's other class)
    out = {}
    for side, pkg, Ts, Ref in (("jax", jprsem, JTranscripts, JReference),
                               ("port", pprsem, PTranscripts, PReference)):
        tmp = d / f"learn_{model}_{side}"
        tmp.mkdir()
        ts = Ts.read_ti("gref.ti")
        cfg = pkg.PrsemConfig(partition_model=model, temp_dir=str(tmp),
                              **LEARN_CASES[model])
        res = pkg.learn_prior(
            ts, pme, cfg, imd_name=str(tmp / "s"), stat_name=str(tmp / "s"),
            ref=Ref.load_seq("gref.seq"), efflen=np.full(len(genes), 1100.0),
            pme_tpm=pme / pme.sum() * 1e6, log=lambda *a: None)
        out[side] = (tmp, res)
    (jtmp, jres), (ptmp, pres) = out["jax"], out["port"]
    assert np.array_equal(pres.prior, jres.prior)
    assert np.array_equal(pres.partition, jres.partition)
    assert np.array_equal(pres.is_training, jres.is_training)
    assert (pres.pvalue, pres.loglikelihood, pres.informative) == (
        jres.pvalue, jres.loglikelihood, jres.informative) or (
        np.isnan(jres.pvalue) and np.isnan(pres.pvalue))
    names = sorted(os.listdir(jtmp))
    assert sorted(os.listdir(ptmp)) == names
    for suffix in (".all_tr_features", ".training_tr_crd", ".all_tr_prior",
                   ".pval_LL"):
        f = "s_prsem" + suffix
        assert open(ptmp / f, "rb").read() == open(jtmp / f, "rb").read(), f
    if model == "lm4":
        assert "idr_target_vs_control.regionPeak.gz" in names
    assert len(set(pres.prior[1:])) > 1


# --------------------------------------------------------------------- #
# the driver end to end                                                  #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """JAX and port, each preparing its own reference and running
    calculate-expression --run-pRSEM on tests/test_prsem.py's fixture."""
    out = {}
    for side in ("jax", "port"):
        d = tmp_path_factory.mktemp(f"prsem_{side}")
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(d)
            genome, genes = _make_genome_and_gtf(d)
            _reads_sam(genome, genes, d)
            driver = sys.modules["rsem_tpu.pipeline.calculate_expression"]
            mp.setattr(driver, "run_gibbs", xla_gibbs(driver.run_gibbs))
            mp.setattr(driver, "_production_mesh", lambda n: None)
            prep = ["--gtf", "anno.gtf", "genome.fa", "gref", "-q"]
            argv = ["--alignments", "aln.sam", "gref", "psm", "-q",
                    "--no-bam-output", "--keep-intermediate-files",
                    "--run-pRSEM", "--chipseq-peak-file",
                    "peaks.bed"] + GIBBS
            if side == "jax":
                assert jax_prep(prep) == 0
                assert jax_calc(argv) == 0
            else:
                assert port_cli(["prepare-reference"] + prep) == 0
                assert port_cli(["calculate-expression", "--device", "cpu",
                                 "--time"] + argv) == 0
        out[side] = d
    out["genes"] = genes
    return out


def _table(path):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return rows[0], {r[0]: r for r in rows[1:]}


@pytest.mark.parametrize("kind", ["isoforms", "genes"])
def test_driver_tables_match_jax(driver_runs, kind):
    """The prior-informed tables: headers and rows equal; expected counts
    within 1.0 and TPM within 2e-4 x 1e6 (the golden tolerances);
    posterior_mean_count within max(2 sd, 1.5) of the JAX package's; the
    uniform-prior tables moved to .stat/ with the same header and rows."""
    jh, jt = _table(driver_runs["jax"] / f"psm.{kind}.results")
    ph, pt = _table(driver_runs["port"] / f"psm.{kind}.results")
    assert ph == jh and list(pt) == list(jt)
    assert "posterior_mean_count" in jh and "TPM_ci_lower_bound" not in jh
    ic, it = jh.index("expected_count"), jh.index("TPM")
    i_pme = jh.index("posterior_mean_count")
    i_sd = jh.index("posterior_standard_deviation_of_count")
    for k, jr in jt.items():
        pr = pt[k]
        assert pr[:ic] == jr[:ic], k
        assert abs(float(pr[ic]) - float(jr[ic])) < 1.0, (k, pr, jr)
        assert abs(float(pr[it]) - float(jr[it])) / 1e6 < 2e-4, (k, pr, jr)
        lim = max(2.0 * float(jr[i_sd]), 1.5)
        assert abs(float(pr[i_pme]) - float(jr[i_pme])) < lim, (k, pr, jr)
    n_reads = sum(40 if g[4] else 3 for g in driver_runs["genes"])
    assert sum(float(r[i_pme]) for r in pt.values()) == pytest.approx(
        n_reads, rel=0.02)
    uni = f"psm.stat/psm_uniform_prior_1.{kind}.results"
    juh, jut = _table(driver_runs["jax"] / uni)
    puh, put = _table(driver_runs["port"] / uni)
    assert puh == juh and list(put) == list(jut)


def test_driver_features_match_jax(driver_runs):
    """The partition and the training set of .all_tr_features identical;
    p-value below 0.01 and one prior line per isoform, the peak partition
    with the larger alpha; --time records the two Gibbs runs and the prior
    fit apart, and its headline sums only the JAX driver's stages."""
    cols = {}
    for side in ("jax", "port"):
        h, rows = _table(driver_runs[side] / "psm.temp"
                         / "psm_prsem.all_tr_features")
        cols[side] = {k: (r[h.index("partition")], r[h.index("is_training")],
                          r[h.index("tss_pk")]) for k, r in rows.items()}
    assert cols["port"] == cols["jax"]
    d = driver_runs["port"]
    pval = float(open(d / "psm.stat" / "psm_prsem.pval_LL").read()
                 .splitlines()[1].split("\t")[0])
    assert pval < 0.01
    prior = {}
    for line in open(d / "psm.temp" / "psm_prsem.all_tr_prior"):
        val, _, trid = line.split()
        prior[trid] = float(val)
    genes = driver_runs["genes"]
    assert len(prior) == len(genes)
    assert min(prior[g[1]] for g in genes if g[4]) > max(
        prior[g[1]] for g in genes if not g[4])
    stages = open(d / "psm.time").read()
    for stage in ("em", "gibbs", "prsem-prior", "gibbs-prior", "tables"):
        assert f"# {stage}: " in stages, stage
    lines = stages.splitlines()
    est = float(lines[1].split(": ")[1].split()[0])
    secs = {}
    for line in lines[3:]:
        name, dt = line[2:].split(": ")
        secs[name] = secs.get(name, 0.0) + float(dt.split()[0])
    jax_stages = ("parse-alignments", "em", "gibbs", "bam-output")
    assert est == pytest.approx(sum(secs.get(n, 0.0) for n in jax_stages),
                                abs=0.01)


def test_testing_procedure_same_on_jax_sample(driver_runs, tmp_path,
                                              monkeypatch):
    """run-prsem-testing-procedure through both CLIs on the JAX run's
    sample directory: the same p-value and log-likelihood lines, and the
    same pval_LL file."""
    from rsem_tpu.__main__ import main as jax_cli

    printed = {}
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        d = tmp_path / side
        shutil.copytree(driver_runs["jax"], d)
        monkeypatch.chdir(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli(["run-prsem-testing-procedure", "gref", "psm",
                        "--chipseq-peak-file", "peaks.bed"]) == 0
        printed[side] = (buf.getvalue().splitlines()[-2:],
                         open("psm.stat/psm_prsem.pval_LL").read())
    assert printed["port"] == printed["jax"]
    assert printed["port"][0][0].startswith("p-value\t")
    os.remove(d / "psm.isoforms.results")
    shutil.copy(d / "psm.stat" / "psm_uniform_prior_1.isoforms.results",
                d / "psm.isoforms.results")
    _h, rows = _table(d / "psm.isoforms.results")
    with open(d / "psm.isoforms.results", "w") as f:
        f.write("\t".join(_h[:8]) + "\n")
        for r in rows.values():
            f.write("\t".join(r[:8]) + "\n")
    assert port_cli(["run-prsem-testing-procedure", "gref", "psm",
                     "--chipseq-peak-file", "peaks.bed", "-q"]) == 2


def test_prsem_phase_at_toy_size(tmp_path):
    """chip_smoke.py's phase 15 on the CPU at a toy size: the pRSEM run
    through the port's CLI on a seeded genome with one-isoform genes,
    both Gibbs runs held on their own inputs, and the ChIP-seq leg on
    tagAlign replicates; the phase's own gates."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    launches, k5_runs, out = chip_smoke.phase_prsem(
        str(tmp_path), device="cpu", n_genes=120, n_single=80,
        n_reads=30000, n_chrom=2, chrom_len=360_000, n_tags=40000,
        gibbs_args=("--gibbs-burnin", "20", "--gibbs-number-of-samples",
                    "80", "--gibbs-chains", "2"))
    assert all(n == 0 for n in launches.values())  # plain versions on CPU
    assert k5_runs == [0, 0]
    assert out["training_set"] == 80 and out["pvalue"] < 0.01
    assert out["alpha"][1] > out["alpha"][0]
    assert set(out["path_kernels_max_abs_err"]) == {
        "em", "gibbs, uniform prior", "gibbs, pRSEM prior"}
    assert out["chip"]["planted_hit"] == out["chip"]["planted_peaks"]
