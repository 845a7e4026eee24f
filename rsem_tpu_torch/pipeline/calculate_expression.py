"""The quantification driver (rsem-calculate-expression equivalent).

Counterpart of rsem_tpu/pipeline/calculate_expression.py: [reads ->
external aligner] -> transcript alignments (SAM/BAM, optionally name-sorted
first) -> model estimation -> EM on the device -> optionally the collapsed
Gibbs sampler (--calc-pme) and credibility intervals (--calc-ci) on the
device -> results tables (with .alleles.results and transcript-level
isoform tables for an allele-specific reference) -> transcript BAM, its
genome-coordinate conversion and coordinate-sorted, indexed copies.
Interop artifacts (.cnt/.model/.theta/.mparams; .ofg and .countvectors
with --keep-intermediate-files) are written under sample_name.stat/ and
sample_name.temp/ as the reference does. With --run-pRSEM the uniform-prior
posterior feeds pRSEM's prior fit on the host (prsem/), and a second Gibbs
run on the device with the learned pseudo-counts gives the final PME columns.

Several processes: with the RSEM_TPU_* variables set (or under torchrun,
parallel/distributed.py) every process joins the process group at entry,
parses the whole input, and passes the group to the EM (reads sharded over
the ranks), to both Gibbs runs (chains split where they tile the ranks)
and to CI (count vectors, then transcript columns split); every rank then
holds the same results. Only rank 0 writes files (tables, .stat, .temp,
BAMs, .time) and runs the aligner, the input sort and pRSEM's prior fit,
whose results the others receive; the JAX package lets every process
write the same files.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..constants import DEFAULT_SEED_LEN
from ..engine.ci import CIConfig, run_ci
from ..engine.em import EMConfig, run_em, write_theta_file
from ..engine.gibbs import GibbsConfig, run_gibbs
from ..io import parse_alignments
from ..io.bam_writer import write_transcript_bam
from ..io.bamsort import sort_bam
from ..io.results import (
    ALLELE_TITLE_PME,
    GENE_TITLE_CI,
    GENE_TITLE_PME,
    ISO_TITLE_CI,
    ISO_TITLE_PME,
    gene_level_values,
    transcript_level_values,
    within_gene_pct,
    write_allele_results,
    write_gene_results,
    write_isoform_results,
    write_transcript_results_allele,
)
from ..io.sam import finalize_cnt
from ..io.tbam2gbam import tbam2gbam
from ..model import GenerativeModel, ModelSpec
from ..parallel.distributed import maybe_initialize, on_root
from ..refprep.reference import Reference
from ..refprep.transcripts import GroupInfo, Transcripts
from ..utils.device import DeviceLike, resolve_device
from .aligners import AlignerConfig, run_alignment


@dataclass
class ExpressionConfig:
    """The reference CLI surface (rsem-calculate-expression:129-205)."""

    paired_end: bool = False
    no_qualities: bool = False
    strandedness: str = "none"  # none | forward | reverse
    seed: Optional[int] = None
    seed_length: int = DEFAULT_SEED_LEN
    # model
    fragment_length_min: int = 1
    fragment_length_max: int = 1000
    fragment_length_mean: float = -1.0
    fragment_length_sd: float = 0.0
    estimate_rspd: bool = False
    num_rspd_bins: int = 20
    # posterior
    calc_pme: bool = False
    calc_ci: bool = False
    gibbs_burnin: int = 200
    gibbs_number_of_samples: int = 1000
    gibbs_sampling_gap: int = 1
    gibbs_chains: int = 8
    ci_credibility_level: float = 0.95
    ci_number_of_samples_per_count_vector: int = 50
    single_cell_prior: bool = False
    # pRSEM (rsem-calculate-expression:115-126,182-194,743-811)
    run_prsem: bool = False
    chipseq_peak_file: str = ""
    partition_model: str = "pk"
    mappability_bedgraph_file: Optional[str] = None
    chipseq_target_read_files: str = ""  # colon-separated replicates
    chipseq_control_read_files: str = ""
    chipseq_read_files_multi_targets: str = ""
    chipseq_bed_files_multi_targets: str = ""
    cap_stacked_chipseq_reads: bool = False
    n_max_stacked_chipseq_reads: int = 5
    chipseq_target_signals: str = ""  # pooled tagAlign for signal models
    chipseq_bowtie_index: str = ""  # genome bowtie index (default: ref name)
    chipseq_bowtie_path: str = ""
    # BAM output (rsem-calculate-expression:94-99,505-527,645-674)
    no_bam_output: bool = False
    sampling_for_bam: bool = False
    output_genome_bam: bool = False
    sort_bam_by_coordinate: bool = False
    sort_bam_by_read_name: bool = False  # sorts the input before parsing
    # misc
    append_names: bool = False
    tag: str = "XM"
    keep_intermediate_files: bool = False
    quiet: bool = False
    fai: Optional[str] = None  # .fai for header-less SAM inputs
    record_time: bool = False  # --time -> sample_name.time
    temporary_folder: Optional[str] = None
    profile_dir: Optional[str] = None  # torch.profiler trace output
    aligning_seconds: float = 0.0  # filled by main() when it ran an aligner

    @property
    def read_type(self) -> int:
        return (2 if self.paired_end else 0) + (0 if self.no_qualities else 1)

    @property
    def probF(self) -> float:
        return {"none": 0.5, "forward": 1.0, "reverse": 0.0}[self.strandedness]


@dataclass
class ExpressionResult:
    em: object
    gibbs: Optional[object] = None
    ci: Optional[object] = None
    cnt: Optional[object] = None


def _stage_seeds(seed: Optional[int]):
    if seed is None:
        return [None, None, None]
    rng = np.random.RandomState(seed)
    return [int(x) for x in rng.randint(0, 2**31, size=3)]


def _pct(num: np.ndarray, denom: np.ndarray) -> np.ndarray:
    """num/denom*100 where denom >= EPSILON, else 0 (WriteResults.h:383+)."""
    out = np.zeros_like(np.asarray(num, dtype=np.float64))
    ok = denom >= 1e-300
    out[ok] = num[ok] / denom[ok] * 100.0
    return out


def _check_prsem(cfg: ExpressionConfig, allele: bool, posterior: bool):
    """The JAX driver's pRSEM refusals, made before any work is done."""
    if allele:
        raise ValueError("pRSEM is not supported in allele mode")
    if not posterior:
        raise ValueError(
            "--run-pRSEM requires --calc-pme (pRSEM learns its prior "
            "from posterior mean counts)"
        )
    if not (cfg.chipseq_peak_file or cfg.chipseq_target_read_files
            or cfg.chipseq_read_files_multi_targets
            or cfg.chipseq_bed_files_multi_targets):
        raise ValueError(
            "--run-pRSEM requires --chipseq-peak-file, "
            "--chipseq-target-read-files (+ --chipseq-control-read-"
            "files), or --chipseq-{read,bed}-files-multi-targets"
        )


def _learn_prior(cfg: ExpressionConfig, ts, ref, em, gres,
                 reference_name: str, imd: str, stat: str):
    """pRSEM's prior from the uniform-prior posterior mean counts (host)."""
    from ..prsem import PrsemConfig, learn_prior

    def _split(s):
        return [x for x in s.split(":") if x] if s else []

    return learn_prior(
        ts,
        gres.pme_c[1:],
        PrsemConfig(
            chipseq_peak_file=cfg.chipseq_peak_file,
            partition_model=cfg.partition_model,
            mappability_file=cfg.mappability_bedgraph_file,
            chipseq_target_read_files=_split(cfg.chipseq_target_read_files),
            chipseq_control_read_files=_split(
                cfg.chipseq_control_read_files),
            chipseq_read_files_multi_targets=_split(
                cfg.chipseq_read_files_multi_targets),
            chipseq_bed_files_multi_targets=_split(
                cfg.chipseq_bed_files_multi_targets),
            cap_stacked_chipseq_reads=cfg.cap_stacked_chipseq_reads,
            n_max_stacked_chipseq_reads=cfg.n_max_stacked_chipseq_reads,
            chipseq_target_signals=cfg.chipseq_target_signals,
            bowtie_index=cfg.chipseq_bowtie_index or reference_name,
            bowtie_path=cfg.chipseq_bowtie_path,
            temp_dir=os.path.dirname(imd) or ".",
        ),
        imd_name=imd,
        stat_name=stat,
        ref=ref,
        efflen=em.eel[1:],
        pme_tpm=gres.pme_tpm[1:],
        log=(lambda *a: None) if cfg.quiet else print,
    )


def _prior_of(pres):
    """What the Gibbs rerun needs of pRSEM's fit: (informative, prior)."""
    return pres.informative, pres.prior


def _pme_columns(gres, gi, sid2g: np.ndarray):
    """The PME columns of an isoform table (not allele-specific) and of the
    gene table, and the genes' PME TPM."""
    g_tpm = np.bincount(sid2g, weights=gres.pme_tpm[1:], minlength=gi.m)
    g_c = np.bincount(sid2g, weights=gres.pme_c[1:], minlength=gi.m)
    g_fpkm = np.bincount(sid2g, weights=gres.pme_fpkm[1:], minlength=gi.m)
    isopct = _pct(gres.pme_tpm[1:], g_tpm[sid2g])
    iso = (ISO_TITLE_PME, np.stack(
        [gres.pme_c, np.sqrt(gres.pve_c), gres.pme_tpm, gres.pme_fpkm,
         np.concatenate([[0.0], isopct])]))
    gene = (GENE_TITLE_PME, np.stack(
        [g_c, np.sqrt(gres.pve_c_genes), g_tpm, g_fpkm]))
    return iso, gene, g_tpm


def _write_tables(sample_name, ts, ta, gt, gi, tlens, em, gl, tl, allele,
                  append_names, iso_extra, gene_extra, allele_extra):
    """The results tables: isoforms (alleles and transcripts for an
    allele-specific reference) and genes."""
    if allele:
        write_allele_results(
            f"{sample_name}.alleles.results", ts, tlens, em.eel, em.counts,
            em.tpm, em.fpkm, tl.isopct, gl.isopct, append_names,
            allele_extra,
        )
        write_transcript_results_allele(
            f"{sample_name}.isoforms.results", ts, ta, gt, tl,
            within_gene_pct(gt, tl.tpm, gl.tpm), append_names, iso_extra,
        )
    else:
        write_isoform_results(
            f"{sample_name}.isoforms.results", ts, tlens, em.eel, em.counts,
            em.tpm, em.fpkm, gl.isopct, append_names, iso_extra,
        )
    write_gene_results(
        f"{sample_name}.genes.results", ts, gi, gl, append_names, gene_extra,
    )


def calculate_expression(
    alignments: str,
    reference_name: str,
    sample_name: str,
    cfg: Optional[ExpressionConfig] = None,
    device: DeviceLike = None,
) -> ExpressionResult:
    """alignments: SAM/BAM of transcript alignments (running an aligner is
    `main`'s). Runs the EM (and Gibbs and CI when asked for) on CUDA unless
    device="cpu" is given; joins the process group the environment asks
    for (the module docstring)."""
    from ..utils.timing import StageTimer, maybe_profile, tracing

    cfg = cfg or ExpressionConfig()
    t_start = time.time()
    timer = StageTimer()
    with timer.stage("process-group", headline=False):
        dist = maybe_initialize(device)
    dev = dist.device if dist is not None else resolve_device(device)
    writer = dist is None or dist.root  # the one process that writes
    quiet = cfg.quiet or not writer
    sample_token = os.path.basename(sample_name)
    temp_dir = cfg.temporary_folder or f"{sample_name}.temp"
    stat_dir = f"{sample_name}.stat"
    if writer:
        os.makedirs(temp_dir, exist_ok=True)
        os.makedirs(stat_dir, exist_ok=True)
    imd = os.path.join(temp_dir, sample_token)
    stat = os.path.join(stat_dir, sample_token)

    # ---- reference ----
    # (the stages the JAX driver does not time stay out of the .time
    # file's headline: process-group, load-reference, intermediate-files,
    # tables, pRSEM's)
    with timer.stage("load-reference", headline=False):
        ref = Reference.load_seq(f"{reference_name}.seq")
        ts = Transcripts.read_ti(f"{reference_name}.ti")
        gi = GroupInfo.load(f"{reference_name}.grp")
        allele = os.path.exists(f"{reference_name}.gt") and os.path.exists(
            f"{reference_name}.ta")
        ta = GroupInfo.load(f"{reference_name}.ta") if allele else None
        gt = GroupInfo.load(f"{reference_name}.gt") if allele else None
    posterior = cfg.calc_pme or cfg.calc_ci
    if cfg.run_prsem:
        _check_prsem(cfg, allele, posterior)
    names = [""] + [
        (t.seqname if ts.is_allele_specific else t.transcript_id)
        for t in ts.transcripts
    ]

    spec = ModelSpec(
        model_type=cfg.read_type,
        est_rspd=cfg.estimate_rspd,
        B=cfg.num_rspd_bins,
        minL=cfg.fragment_length_min,
        maxL=cfg.fragment_length_max,
        mate_minL=1,
        mate_maxL=cfg.fragment_length_max,
        mean=cfg.fragment_length_mean,
        sd=cfg.fragment_length_sd,
        probF=cfg.probF,
        seed_len=cfg.seed_length,
        has_polya=ref.has_polya,
    )
    if writer:
        spec.write_mparams(f"{imd}.mparams")

    # ---- optional input name-sort (rsem-calculate-expression:567-575) ----
    if cfg.sort_bam_by_read_name:
        with timer.stage("sort-by-read-name"):
            sorted_inp = f"{imd}.sorted.bam"
            on_root(lambda: sort_bam(alignments, sorted_inp, by="name",
                                     keep_pairs=True), dist)
        alignments = sorted_inp

    # ---- parse alignments (rsem-parse-alignments) ----
    with timer.stage("parse-alignments"):
        bundle = parse_alignments(
            alignments, names, cfg.read_type, ref.has_polya, cfg.seed_length,
            filter_tag=cfg.tag, use_native=True, fai=cfg.fai,
        )
    sid2gid = np.concatenate([[0], gi.gids_of(np.arange(1, ts.M + 1))])
    finalize_cnt(bundle, sid2gid)
    if writer:
        bundle.cnt.write(f"{stat}.cnt")
        with open(f"{imd}.omit", "w") as f:
            for sid in bundle.omit:
                f.write(f"{sid}\n")
    if bundle.cnt.N1 == 0:
        raise RuntimeError("No alignable reads; nothing to estimate.")

    # ---- EM ----
    need_posteriors = ((not cfg.no_bam_output) or cfg.keep_intermediate_files
                       or posterior)
    # with --time the EM's own spans become comment lines of the .time file
    em_trace = tracing() if cfg.record_time else contextlib.nullcontext([])
    with timer.stage("em"), maybe_profile(
            cfg.profile_dir if writer else None), em_trace as em_spans:
        model = GenerativeModel(spec, ref)
        model.estimate_from_stats(bundle.stats)
        em = run_em(model, ref, bundle, EMConfig(verbose=not quiet),
                    need_posteriors=need_posteriors, device=dev, dist=dist)
    timer.add_spans(em_spans)

    if writer:
        model.write(f"{stat}.model")
        write_theta_file(f"{stat}.theta", em.theta_raw, em.theta)
    if cfg.keep_intermediate_files and writer:
        # stage-restart surface (EM.cpp:435-457): final-model conditional
        # probabilities, consumable by rsem-run-gibbs
        from ..io.ofg import write_ofg

        with timer.stage("intermediate-files", headline=False):
            write_ofg(f"{imd}.ofg", ref.M, bundle.cnt.N0, bundle.hits,
                      em.log_conprb, em.log_ncp)

    tlens = ts.lengths()
    gl = gene_level_values(gi, tlens, em.eel, em.counts, em.tpm, em.fpkm)
    tl = (transcript_level_values(ta, tlens, em.eel, em.counts, em.tpm,
                                  em.fpkm) if allele else None)
    iso_extra, gene_extra, allele_extra = [], [], []
    seeds = _stage_seeds(cfg.seed)
    pseudo_count = 0.1 if cfg.single_cell_prior else 1.0
    sid2g = sid2gid[1:]

    # ---- Gibbs (--calc-pme / --calc-ci) ----
    gres = cires = None
    if posterior:
        gcfg = GibbsConfig(
            burnin=cfg.gibbs_burnin,
            nsamples=cfg.gibbs_number_of_samples,
            gap=cfg.gibbs_sampling_gap,
            n_chains=cfg.gibbs_chains,
            pseudo_count=pseudo_count,
            seed=seeds[1] if seeds[1] is not None else 0,
            keep_countvectors=cfg.calc_ci or cfg.keep_intermediate_files,
        )
        with timer.stage("gibbs"):
            gres = run_gibbs(
                bundle.hits, em.log_conprb, em.log_ncp, ref.M, bundle.cnt.N0,
                em.eel, model.mw, gi, gcfg, omit=bundle.omit, device=dev,
                ta=ta, dist=dist,
            )
        if cfg.keep_intermediate_files and writer:
            from ..io.ofg import write_countvectors

            # Gibbs.cpp:255-262 (one file; the reference writes one per
            # thread and calcCI globs them)
            with timer.stage("intermediate-files", headline=False):
                write_countvectors(f"{imd}.countvectors",
                                   gres.countvectors.cpu().numpy())
        iso_pme, gene_pme, gene_pme_tpm = _pme_columns(gres, gi, sid2g)
        gene_extra.append(gene_pme)
        if not allele:
            iso_extra.append(iso_pme)
        else:
            sid_pme = [gres.pme_c, np.sqrt(gres.pve_c), gres.pme_tpm,
                       gres.pme_fpkm]
            sid2tid = ta.gids_of(np.arange(1, ref.M + 1))
            trans_pme_c = np.bincount(sid2tid, weights=gres.pme_c[1:],
                                      minlength=ta.m)
            trans_pme_tpm = np.bincount(sid2tid, weights=gres.pme_tpm[1:],
                                        minlength=ta.m)
            trans_pme_fpkm = np.bincount(sid2tid, weights=gres.pme_fpkm[1:],
                                         minlength=ta.m)
            tid2gid = gt.gids_of(np.arange(ta.m))
            allele_iso_pme = _pct(gres.pme_tpm[1:], trans_pme_tpm[sid2tid])
            allele_gene_pme = _pct(gres.pme_tpm[1:], gene_pme_tpm[sid2g])
            allele_extra.append((ALLELE_TITLE_PME, np.stack(
                sid_pme + [np.concatenate([[0.0], allele_iso_pme]),
                           np.concatenate([[0.0], allele_gene_pme])])))
            iso_extra.append((ISO_TITLE_PME, np.stack(
                [trans_pme_c, np.sqrt(gres.pve_c_trans), trans_pme_tpm,
                 trans_pme_fpkm,
                 _pct(trans_pme_tpm, gene_pme_tpm[tid2gid])])))

    # ---- credibility intervals (--calc-ci) ----
    if cfg.calc_ci:
        cicfg = CIConfig(
            confidence=cfg.ci_credibility_level,
            nspc=cfg.ci_number_of_samples_per_count_vector,
            pseudo_count=pseudo_count,
            seed=seeds[2] if seeds[2] is not None else 0,
        )
        with timer.stage("ci"):
            cires = run_ci(gres.countvectors, em.eel, model.mw, gi, cicfg,
                           device=dev, ta=ta, dist=dist)

        def ci_cols(tpm_b, fpkm_b):
            return (ISO_TITLE_CI, np.stack(
                [tpm_b.lb, tpm_b.ub, tpm_b.cqv, fpkm_b.lb, fpkm_b.ub,
                 fpkm_b.cqv]))

        if allele:
            allele_extra.append(ci_cols(cires.tpm, cires.fpkm))
            iso_extra.append(ci_cols(cires.iso_tpm, cires.iso_fpkm))
        else:
            iso_extra.append(ci_cols(cires.tpm, cires.fpkm))
        gene_extra.append(ci_cols(cires.gene_tpm, cires.gene_fpkm))

    # ---- final tables ----
    if writer:
        with timer.stage("tables", headline=False):
            _write_tables(sample_name, ts, ta, gt, gi, tlens, em, gl, tl,
                          allele, cfg.append_names, iso_extra, gene_extra,
                          allele_extra)

    # ---- pRSEM: ChIP-seq-informed prior + Gibbs rerun on the device ----
    # (rsem-calculate-expression:743-811; pRSEM/prsem-calculate-expression)
    if cfg.run_prsem:
        with timer.stage("prsem-prior", headline=False):
            informative, prior = on_root(lambda: _prior_of(_learn_prior(
                cfg, ts, ref, em, gres, reference_name, imd, stat)), dist)
        if informative:
            # the uniform-prior tables become the *_uniform_prior_1 artifacts
            if writer:
                for kind in ("isoforms", "genes"):
                    os.replace(f"{sample_name}.{kind}.results",
                               f"{stat}_uniform_prior_1.{kind}.results")
            with timer.stage("gibbs-prior", headline=False):
                gres = run_gibbs(
                    bundle.hits, em.log_conprb, em.log_ncp, ref.M,
                    bundle.cnt.N0, em.eel, model.mw, gi, gcfg,
                    omit=bundle.omit, prior=prior, device=dev, dist=dist)
            # pRSEM's results: the EM columns and the prior-informed PME
            # columns only (collectResults over head-8/tail-5 of iso_res,
            # rsem-calculate-expression:789-796)
            iso_pme, gene_pme, _ = _pme_columns(gres, gi, sid2g)
            if writer:
                with timer.stage("tables", headline=False):
                    write_isoform_results(
                        f"{sample_name}.isoforms.results", ts, tlens, em.eel,
                        em.counts, em.tpm, em.fpkm, gl.isopct,
                        cfg.append_names, [iso_pme])
                    write_gene_results(
                        f"{sample_name}.genes.results", ts, gi, gl,
                        cfg.append_names, [gene_pme])

    # ---- posterior-weighted BAM output (rsem-calculate-expression:645-674);
    # the stages split what the JAX driver's .time calls bam-output
    if not cfg.no_bam_output and writer:
        bam_path = f"{sample_name}.transcript.bam"
        with timer.stage("bam-output"):
            write_transcript_bam(
                alignments, bam_path, bundle.hits, em.frac_hit,
                em.frac_noise, paired=cfg.paired_end,
                sampling=cfg.sampling_for_bam, seed=seeds[0], command=None,
            )
        bams = [(bam_path, f"{sample_name}.transcript.sorted.bam")]
        if cfg.output_genome_bam:
            genome_bam = f"{sample_name}.genome.bam"
            with timer.stage("tbam2gbam"):
                tbam2gbam(reference_name, bam_path, genome_bam)
            bams.append((genome_bam, f"{sample_name}.genome.sorted.bam"))
        if cfg.sort_bam_by_coordinate:
            with timer.stage("sort-bam-by-coordinate"):
                for src, dst in bams:
                    sort_bam(src, dst, by="coordinate", build_index=True)

    if writer and not cfg.keep_intermediate_files and \
            cfg.temporary_folder is None:
        shutil.rmtree(temp_dir, ignore_errors=True)
    if cfg.record_time and writer:
        timer.write_time_file(f"{sample_name}.time",
                              aligning=cfg.aligning_seconds)
    if not quiet:
        print(
            f"calculate_expression finished in {time.time() - t_start:.1f}s "
            f"({em.rounds} EM rounds, device {dev}). Stage breakdown:"
        )
        timer.report(log=print, n_reads=bundle.cnt.n_tot)
    return ExpressionResult(em=em, gibbs=gres, ci=cires, cnt=bundle.cnt)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rsem-tpu-torch-calculate-expression",
        description="Estimate expression from RNA-Seq reads (running an "
        "external aligner) or from transcript alignments (SAM/BAM) with the "
        "PyTorch/CUDA port.",
    )
    p.add_argument(
        "inputs", nargs="+",
        help="upstream_read_file(s) [downstream_read_file(s)] "
        "reference_name sample_name; with --alignments: input "
        "reference_name sample_name (read-file lists are comma-separated)",
    )
    p.add_argument("--sam", action="store_true",
                   help="deprecated alias: input is SAM (implies "
                   "--alignments)")
    p.add_argument("--bam", action="store_true",
                   help="deprecated alias: input is BAM (implies "
                   "--alignments)")
    p.add_argument("--alignments", nargs="?", const=True, default=None,
                   metavar="SAM/BAM",
                   help="input is SAM/BAM aligned to the transcript "
                   "reference (skip the aligner step)")
    p.add_argument("--device", default=None,
                   help="torch device: cuda (default) or cpu")
    # aligner selection + knobs (rsem-calculate-expression:33-67,391-565)
    p.add_argument("--bowtie", dest="use_bowtie", action="store_true")
    p.add_argument("--bowtie2", action="store_true")
    p.add_argument("--star", action="store_true")
    p.add_argument("--hisat2-hca", action="store_true")
    p.add_argument("--bowtie-path", default="")
    p.add_argument("--bowtie2-path", default="")
    p.add_argument("--star-path", default="")
    p.add_argument("--hisat2-path", default="")
    p.add_argument("--bowtie-n", type=int, default=2)
    p.add_argument("--bowtie-e", type=int, default=99999999)
    p.add_argument("--bowtie-m", type=int, default=200)
    p.add_argument("--bowtie-chunkmbs", type=int, default=0)
    p.add_argument("--bowtie2-mismatch-rate", type=float, default=0.1)
    p.add_argument("--bowtie2-k", type=int, default=200)
    p.add_argument("--bowtie2-sensitivity-level", default="sensitive",
                   choices=["very_fast", "fast", "sensitive",
                            "very_sensitive"])
    p.add_argument("--star-gzipped-read-file", action="store_true")
    p.add_argument("--star-bzipped-read-file", action="store_true")
    p.add_argument("--phred33-quals", action="store_true", default=True)
    p.add_argument("--phred64-quals", action="store_true", default=False)
    p.add_argument("--solexa-quals", action="store_true", default=False)
    p.add_argument("-p", "--num-threads", type=int, default=1,
                   help="the aligner's threads")
    p.add_argument("--paired-end", action="store_true")
    p.add_argument("--no-qualities", action="store_true")
    p.add_argument("--strandedness", choices=["none", "forward", "reverse"],
                   default="none")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--seed-length", type=int, default=DEFAULT_SEED_LEN)
    p.add_argument("--fragment-length-min", type=int, default=1)
    p.add_argument("--fragment-length-max", type=int, default=1000)
    p.add_argument("--fragment-length-mean", type=float, default=-1.0)
    p.add_argument("--fragment-length-sd", type=float, default=0.0)
    p.add_argument("--estimate-rspd", action="store_true")
    p.add_argument("--num-rspd-bins", type=int, default=20)
    p.add_argument("--calc-pme", action="store_true")
    p.add_argument("--calc-ci", action="store_true")
    p.add_argument("--gibbs-burnin", type=int, default=200)
    p.add_argument("--gibbs-number-of-samples", type=int, default=1000)
    p.add_argument("--gibbs-sampling-gap", type=int, default=1)
    p.add_argument("--gibbs-chains", type=int, default=8,
                   help="independent Gibbs chains (the reference's -p "
                   "threads); must divide --gibbs-number-of-samples")
    p.add_argument("--ci-credibility-level", type=float, default=0.95)
    p.add_argument("--ci-number-of-samples-per-count-vector", type=int,
                   default=50)
    p.add_argument("--single-cell-prior", action="store_true")
    p.add_argument("--run-pRSEM", dest="run_prsem", action="store_true")
    p.add_argument("--chipseq-peak-file", default="")
    p.add_argument("--partition-model", default="pk")
    p.add_argument("--mappability-bedgraph-file", default=None)
    # ChIP-seq leg: colon-separated replicates, commas within a replicate
    # (rsem-calculate-expression:116-126,183-192)
    p.add_argument("--chipseq-target-read-files", default="")
    p.add_argument("--chipseq-control-read-files", default="")
    p.add_argument("--chipseq-read-files-multi-targets", default="")
    p.add_argument("--chipseq-bed-files-multi-targets", default="")
    p.add_argument("--cap-stacked-chipseq-reads", action="store_true")
    p.add_argument("--n-max-stacked-chipseq-reads", type=int, default=5)
    p.add_argument("--chipseq-target-signals", default="",
                   help="pooled target tagAlign(.gz) for signal-based "
                   "partition models when supplying --chipseq-peak-file")
    p.add_argument("--chipseq-bowtie-index", default="")
    p.add_argument("--chipseq-bowtie-path", default="")
    p.add_argument("--no-bam-output", action="store_true")
    p.add_argument("--sampling-for-bam", action="store_true")
    p.add_argument("--output-genome-bam", action="store_true")
    p.add_argument("--sort-bam-by-coordinate", action="store_true")
    p.add_argument("--sort-bam-by-read-name", action="store_true")
    p.add_argument("--append-names", action="store_true")
    p.add_argument("--tag", default="XM")
    p.add_argument("--keep-intermediate-files", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--fai", default=None,
                   help=".fai giving target names/lengths for SAM inputs "
                   "without @SQ header lines")
    p.add_argument("--time", dest="record_time", action="store_true",
                   help="write per-stage wall-clock to sample_name.time")
    p.add_argument("--temporary-folder", default=None)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the EM stage here "
                   "(it carries the EM's rsem.* ranges beside the device "
                   "work)")
    return p


def _resolve_inputs(args):
    """Split the positional inputs into (alignment_file_or_None, read_lists,
    reference_name, sample_name) following the reference's 3/4-positional
    convention (rsem-calculate-expression:337-348)."""
    pos = list(args.inputs)
    if args.alignments is None and (args.sam or args.bam):
        args.alignments = True  # deprecated aliases imply --alignments
    if args.alignments is not None:
        if isinstance(args.alignments, str):
            if len(pos) != 2:
                raise SystemExit(
                    "with --alignments <file>: reference_name sample_name")
            return args.alignments, None, pos[0], pos[1]
        if len(pos) != 3:
            raise SystemExit(
                "with --alignments: input reference_name sample_name")
        return pos[0], None, pos[1], pos[2]
    if args.paired_end:
        if len(pos) != 4:
            raise SystemExit(
                "paired-end: upstream_read_file(s) downstream_read_file(s) "
                "reference_name sample_name")
        return None, (pos[0], pos[1]), pos[2], pos[3]
    if len(pos) != 3:
        raise SystemExit(
            "single-end: upstream_read_file(s) reference_name sample_name")
    return None, (pos[0], None), pos[1], pos[2]


def aligner_config(args, probF: float) -> AlignerConfig:
    """The aligner run the flags ask for (Bowtie unless --bowtie2, --star
    or --hisat2-hca)."""
    aligner = "bowtie"
    if args.bowtie2:
        aligner = "bowtie2"
    elif args.star:
        aligner = "star"
    elif args.hisat2_hca:
        aligner = "hisat2-hca"
    return AlignerConfig(
        aligner=aligner,
        n_threads=args.num_threads,
        no_qualities=args.no_qualities,
        phred33=not (args.phred64_quals or args.solexa_quals),
        phred64=args.phred64_quals,
        solexa=args.solexa_quals,
        probF=probF,
        quiet=args.quiet,
        bowtie_path=args.bowtie_path,
        bowtie_n=args.bowtie_n,
        bowtie_e=args.bowtie_e,
        bowtie_m=args.bowtie_m,
        bowtie_chunkmbs=args.bowtie_chunkmbs,
        seed_length=args.seed_length,
        bowtie2_path=args.bowtie2_path,
        bowtie2_mismatch_rate=args.bowtie2_mismatch_rate,
        bowtie2_k=args.bowtie2_k,
        bowtie2_sensitivity_level=args.bowtie2_sensitivity_level,
        fragment_length_min=args.fragment_length_min,
        fragment_length_max=args.fragment_length_max,
        star_path=args.star_path,
        star_gzipped_read_file=args.star_gzipped_read_file,
        star_bzipped_read_file=args.star_bzipped_read_file,
        hisat2_path=args.hisat2_path,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    input_file, read_lists, reference_name, sample_name = _resolve_inputs(
        args)
    device = resolve_device(args.device)  # before a long aligner run
    cfg = ExpressionConfig(
        paired_end=args.paired_end,
        no_qualities=args.no_qualities,
        strandedness=args.strandedness,
        seed=args.seed,
        seed_length=args.seed_length,
        fragment_length_min=args.fragment_length_min,
        fragment_length_max=args.fragment_length_max,
        fragment_length_mean=args.fragment_length_mean,
        fragment_length_sd=args.fragment_length_sd,
        estimate_rspd=args.estimate_rspd,
        num_rspd_bins=args.num_rspd_bins,
        calc_pme=args.calc_pme,
        calc_ci=args.calc_ci,
        gibbs_burnin=args.gibbs_burnin,
        gibbs_number_of_samples=args.gibbs_number_of_samples,
        gibbs_sampling_gap=args.gibbs_sampling_gap,
        gibbs_chains=args.gibbs_chains,
        ci_credibility_level=args.ci_credibility_level,
        ci_number_of_samples_per_count_vector=(
            args.ci_number_of_samples_per_count_vector),
        single_cell_prior=args.single_cell_prior,
        run_prsem=args.run_prsem,
        chipseq_peak_file=args.chipseq_peak_file,
        partition_model=args.partition_model,
        mappability_bedgraph_file=args.mappability_bedgraph_file,
        chipseq_target_read_files=args.chipseq_target_read_files,
        chipseq_control_read_files=args.chipseq_control_read_files,
        chipseq_read_files_multi_targets=args.chipseq_read_files_multi_targets,
        chipseq_bed_files_multi_targets=args.chipseq_bed_files_multi_targets,
        cap_stacked_chipseq_reads=args.cap_stacked_chipseq_reads,
        n_max_stacked_chipseq_reads=args.n_max_stacked_chipseq_reads,
        chipseq_target_signals=args.chipseq_target_signals,
        chipseq_bowtie_index=args.chipseq_bowtie_index,
        chipseq_bowtie_path=args.chipseq_bowtie_path,
        output_genome_bam=args.output_genome_bam,
        sort_bam_by_coordinate=args.sort_bam_by_coordinate,
        sort_bam_by_read_name=args.sort_bam_by_read_name,
        no_bam_output=args.no_bam_output,
        sampling_for_bam=args.sampling_for_bam,
        append_names=args.append_names,
        tag=args.tag,
        keep_intermediate_files=args.keep_intermediate_files,
        quiet=args.quiet,
        fai=args.fai,
        record_time=args.record_time,
        temporary_folder=args.temporary_folder,
        profile_dir=args.profile_dir,
    )
    if input_file is None:
        # run the external aligner (rsem-calculate-expression:391-565),
        # on rank 0 alone when there are several processes
        temp_dir = args.temporary_folder or f"{sample_name}.temp"
        imd = os.path.join(temp_dir, os.path.basename(sample_name))
        t_align = time.time()

        def align():
            os.makedirs(temp_dir, exist_ok=True)
            return run_alignment(
                aligner_config(args, cfg.probF), reference_name, sample_name,
                imd, read_lists[0], read_lists[1],
                log=(lambda *a: None) if args.quiet else print,
            )

        input_file = on_root(align, maybe_initialize(device))
        cfg.aligning_seconds = time.time() - t_align
    calculate_expression(input_file, reference_name, sample_name, cfg,
                         device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
