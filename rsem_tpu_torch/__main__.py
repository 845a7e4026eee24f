"""CLI: `python -m rsem_tpu_torch <command> [args...]`.

Counterpart of rsem_tpu/__main__.py, with every one of its commands: the
pipeline drivers (on the device), and the host tools: BAM-layer tools on the
port's own BAM codec, pRSEM's testing procedure, the data matrix, EBSeq,
the plots (which need matplotlib) and the reference utilities.
"""

from __future__ import annotations

import argparse
import sys


def _cmd_calculate_expression(argv):
    from .pipeline.calculate_expression import main
    return main(argv)


def _cmd_prepare_reference(argv):
    from .pipeline.prepare_reference import main
    return main(argv)


def _cmd_simulate_reads(argv):
    from .pipeline.simulate_reads import main
    return main(argv)


def _cmd_tbam2gbam(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch tbam2gbam")
    p.add_argument("reference_name")
    p.add_argument("input_bam")
    p.add_argument("output_bam")
    a = p.parse_args(argv)
    from .io.tbam2gbam import tbam2gbam
    tbam2gbam(a.reference_name, a.input_bam, a.output_bam,
              command=" ".join(["rsem-tbam2gbam"] + argv))
    return 0


def _cmd_bam2wig(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch bam2wig")
    p.add_argument("sorted_bam_input")
    p.add_argument("wig_output")
    p.add_argument("wiggle_name")
    p.add_argument("--no-fractional-weight", action="store_true")
    a = p.parse_args(argv)
    from .io.wiggle import bam2wig
    bam2wig(a.sorted_bam_input, a.wig_output, a.wiggle_name,
            a.no_fractional_weight)
    return 0


def _cmd_bam2readdepth(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch bam2readdepth")
    p.add_argument("sorted_bam_input")
    p.add_argument("readdepth_output")
    a = p.parse_args(argv)
    from .io.wiggle import bam2readdepth
    bam2readdepth(a.sorted_bam_input, a.readdepth_output)
    return 0


def _cmd_get_unique(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch get-unique")
    p.add_argument("unsorted_transcript_bam_input")
    p.add_argument("bam_output")
    a = p.parse_args(argv)
    from .pipeline.bamtools import get_unique
    get_unique(a.unsorted_transcript_bam_input, a.bam_output)
    print("done!")
    return 0


def _cmd_sam_validator(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch sam-validator")
    p.add_argument("input")
    a = p.parse_args(argv)
    from .pipeline.bamtools import validate_alignments
    ok = validate_alignments(a.input)
    print("The input file is valid!" if ok
          else "The input file is not valid!")
    return 0 if ok else 1


def _cmd_scan_for_paired_end_reads(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch scan-for-paired-end-reads")
    p.add_argument("input")
    p.add_argument("output_bam")
    a = p.parse_args(argv)
    from .pipeline.bamtools import scan_for_paired_end_reads
    scan_for_paired_end_reads(a.input, a.output_bam)
    return 0


def _cmd_convert_sam_for_rsem(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch convert-sam-for-rsem")
    p.add_argument("input")
    p.add_argument("-o", "--output-name", required=True)
    a = p.parse_args(argv)
    from .pipeline.bamtools import convert_sam_for_rsem
    out = convert_sam_for_rsem(a.input, a.output_name)
    print(f"Output written to {out}")
    return 0


def _cmd_sort_bam(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch sort-bam")
    p.add_argument("input_bam")
    p.add_argument("output_bam")
    p.add_argument("--by", choices=["coordinate", "name"],
                   default="coordinate")
    p.add_argument("--index", action="store_true")
    a = p.parse_args(argv)
    from .io.bamsort import sort_bam
    sort_bam(a.input_bam, a.output_bam, by=a.by, build_index=a.index)
    return 0


def _cmd_generate_data_matrix(argv):
    from .pipeline.utilities import generate_data_matrix
    if not argv:
        print("Usage: rsem-tpu-torch generate-data-matrix sampleA.results "
              "sampleB.results ... > output.matrix", file=sys.stderr)
        return 1
    generate_data_matrix(argv, sys.stdout)
    return 0


def _cmd_gff3_to_gtf(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch gff3-to-gtf")
    p.add_argument("gff3_input")
    p.add_argument("gtf_output")
    p.add_argument("--RNA-patterns", default="mRNA")
    p.add_argument("--make-genes-as-transcripts", action="store_true")
    a = p.parse_args(argv)
    from .refprep.gff3 import gff3_to_gtf
    gff3_to_gtf(a.gff3_input, a.gtf_output, a.RNA_patterns,
                a.make_genes_as_transcripts)
    return 0


def _cmd_extract_transcript_to_gene_map_from_trinity(argv):
    p = argparse.ArgumentParser(
        prog="rsem-tpu-torch extract-transcript-to-gene-map-from-trinity"
    )
    p.add_argument("trinity_fasta_file")
    p.add_argument("map_file")
    a = p.parse_args(argv)
    from .pipeline.utilities import extract_trinity_gene_map
    extract_trinity_gene_map(a.trinity_fasta_file, a.map_file)
    return 0


def _cmd_refseq_extract_primary_assembly(argv):
    p = argparse.ArgumentParser(
        prog="rsem-tpu-torch refseq-extract-primary-assembly"
    )
    p.add_argument("input_fna")
    p.add_argument("output_fna")
    a = p.parse_args(argv)
    from .pipeline.utilities import refseq_extract_primary_assembly
    refseq_extract_primary_assembly(a.input_fna, a.output_fna)
    return 0


def _cmd_generate_ngvector(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch generate-ngvector")
    p.add_argument("input_fasta_file")
    p.add_argument("output_name")
    p.add_argument("-k", type=int, default=25)
    p.add_argument("-q", "--quiet", action="store_true")
    a = p.parse_args(argv)
    from .diffexp import generate_ngvector
    generate_ngvector(a.input_fasta_file, a.output_name, k=a.k,
                      quiet=a.quiet)
    return 0


def _cmd_run_ebseq(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch run-ebseq")
    p.add_argument("data_matrix_file")
    p.add_argument("conditions",
                   help="comma-separated replicate counts, e.g. 3,3")
    p.add_argument("output_file")
    p.add_argument("--ngvector", default=None)
    a = p.parse_args(argv)
    conds = [int(x) for x in a.conditions.split(",")]
    if len(conds) < 2:
        print("At least 2 conditions are required!", file=sys.stderr)
        return 2
    from .diffexp import run_ebseq
    run_ebseq(a.data_matrix_file, conds, a.output_file,
              ngvector_file=a.ngvector)
    return 0


def _cmd_control_fdr(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch control-fdr")
    p.add_argument("input_file")
    p.add_argument("fdr_rate", type=float)
    p.add_argument("output_file")
    p.add_argument("--hard-threshold", action="store_true")
    p.add_argument("--soft-threshold", action="store_true")
    a = p.parse_args(argv)
    if a.hard_threshold and a.soft_threshold:
        print("--hard-threshold and --soft-threshold cannot both be set!",
              file=sys.stderr)
        return 2
    from .diffexp import control_fdr
    control_fdr(a.input_file, a.fdr_rate, a.output_file,
                soft=a.soft_threshold)
    return 0


def _cmd_run_prsem_testing_procedure(argv):
    p = argparse.ArgumentParser(
        prog="rsem-tpu-torch run-prsem-testing-procedure",
        description="Test whether external ChIP-seq data is informative for "
        "quantification (pRSEM testing procedure); requires a sample already "
        "quantified with --calc-pme.",
    )
    p.add_argument("reference_name")
    p.add_argument("sample_name")
    p.add_argument("--chipseq-peak-file", required=True)
    p.add_argument("--partition-model", default="pk")
    p.add_argument("--mappability-bedgraph-file", default=None)
    p.add_argument("-q", "--quiet", action="store_true")
    a = p.parse_args(argv)

    import os

    import numpy as np

    from .prsem import PrsemConfig, run_testing_procedure
    from .refprep.transcripts import Transcripts

    ts = Transcripts.read_ti(f"{a.reference_name}.ti")
    iso_path = f"{a.sample_name}.isoforms.results"
    with open(iso_path) as f:
        hdr = f.readline().rstrip("\n").split("\t")
        if "posterior_mean_count" not in hdr:
            print(
                f"{iso_path} lacks posterior_mean_count; rerun "
                "calculate-expression with --calc-pme", file=sys.stderr,
            )
            return 2
        tcol = hdr.index("transcript_id")
        pcol = hdr.index("posterior_mean_count")
        pme = {}
        for line in f:
            fields = line.rstrip("\n").split("\t")
            pme[fields[tcol]] = float(fields[pcol])
    pme_count = np.array(
        [pme[t.transcript_id] for t in ts.transcripts], dtype=np.float64
    )
    token = os.path.basename(a.sample_name)
    stat = os.path.join(f"{a.sample_name}.stat", token)
    run_testing_procedure(
        ts, pme_count,
        PrsemConfig(
            chipseq_peak_file=a.chipseq_peak_file,
            partition_model=a.partition_model,
            mappability_file=a.mappability_bedgraph_file,
        ),
        stat_name=stat if os.path.isdir(f"{a.sample_name}.stat") else None,
        log=(lambda *x: None) if a.quiet else print,
    )
    return 0


def _cmd_plot_model(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch plot-model")
    p.add_argument("sample_name")
    p.add_argument("output_plot_file")
    a = p.parse_args(argv)
    from .plots import plot_model
    plot_model(a.sample_name, a.output_plot_file)
    return 0


def _cmd_plot_transcript_wiggles(argv):
    p = argparse.ArgumentParser(prog="rsem-tpu-torch plot-transcript-wiggles")
    p.add_argument("sample_name")
    p.add_argument("input_list")
    p.add_argument("output_plot_file")
    p.add_argument("--gene-list", action="store_true")
    p.add_argument("--transcript-list", action="store_true")
    p.add_argument("--show-unique", action="store_true")
    a = p.parse_args(argv)
    from .plots import plot_transcript_wiggles
    plot_transcript_wiggles(
        a.sample_name, a.input_list, a.output_plot_file,
        gene_list=a.gene_list, transcript_list=a.transcript_list,
        show_unique=a.show_unique,
    )
    return 0


COMMANDS = {
    "calculate-expression": _cmd_calculate_expression,
    "prepare-reference": _cmd_prepare_reference,
    "simulate-reads": _cmd_simulate_reads,
    "tbam2gbam": _cmd_tbam2gbam,
    "sort-bam": _cmd_sort_bam,
    "bam2wig": _cmd_bam2wig,
    "bam2readdepth": _cmd_bam2readdepth,
    "get-unique": _cmd_get_unique,
    "sam-validator": _cmd_sam_validator,
    "scan-for-paired-end-reads": _cmd_scan_for_paired_end_reads,
    "convert-sam-for-rsem": _cmd_convert_sam_for_rsem,
    "generate-data-matrix": _cmd_generate_data_matrix,
    "run-prsem-testing-procedure": _cmd_run_prsem_testing_procedure,
    "plot-model": _cmd_plot_model,
    "plot-transcript-wiggles": _cmd_plot_transcript_wiggles,
    "generate-ngvector": _cmd_generate_ngvector,
    "run-ebseq": _cmd_run_ebseq,
    "control-fdr": _cmd_control_fdr,
    "gff3-to-gtf": _cmd_gff3_to_gtf,
    "extract-transcript-to-gene-map-from-trinity":
        _cmd_extract_transcript_to_gene_map_from_trinity,
    "refseq-extract-primary-assembly": _cmd_refseq_extract_primary_assembly,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m rsem_tpu_torch <command> [args...]\n\n"
              "commands:")
        for name in sorted(COMMANDS):
            print(f"  {name}")
        return 0 if argv else 1
    fn = COMMANDS.get(argv[0])
    if fn is None:
        print(f"unknown command: {argv[0]}", file=sys.stderr)
        return 1
    return fn(argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
