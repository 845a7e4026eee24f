"""CLI: prepare a reference (rsem-prepare-reference equivalent).

Usage: python -m rsem_tpu_torch prepare-reference [options] \
           reference_fasta_file(s) reference_name
Flags mirror rsem-prepare-reference's (rsem-prepare-reference:52-75). Host
code only: it takes no --device.
"""

from __future__ import annotations

import argparse
import sys

from ..refprep import prepare_reference
from ..refprep.prepare import PrepareConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rsem-tpu-torch-prepare-reference",
        description="Prepare transcript references for rsem_tpu_torch.",
    )
    p.add_argument("reference_fasta_files",
                   help="comma-separated FASTA files (genome with --gtf/--gff3, "
                        "else transcript sequences)")
    p.add_argument("reference_name")
    p.add_argument("--gtf", default=None)
    p.add_argument("--gff3", default=None)
    p.add_argument("--gff3-RNA-patterns", default="mRNA")
    p.add_argument("--gff3-genes-as-transcripts", action="store_true")
    p.add_argument("--trusted-sources", default=None)
    p.add_argument("--transcript-to-gene-map", default=None)
    p.add_argument("--allele-to-gene-map", default=None)
    p.add_argument("--polyA", action="store_true")
    p.add_argument("--polyA-length", type=int, default=125)
    p.add_argument("--no-polyA-subset", default=None)
    # aligner index builds (rsem-prepare-reference:166-204)
    p.add_argument("--bowtie", dest="use_bowtie", action="store_true")
    p.add_argument("--bowtie-path", default="")
    p.add_argument("--bowtie2", action="store_true")
    p.add_argument("--bowtie2-path", default="")
    p.add_argument("--star", action="store_true")
    p.add_argument("--star-path", default="")
    p.add_argument("--star-sjdboverhang", type=int, default=100)
    p.add_argument("--hisat2-hca", action="store_true")
    p.add_argument("--hisat2-path", default="")
    p.add_argument("-p", "--num-threads", type=int, default=1)
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = PrepareConfig(
        gtf=args.gtf,
        gff3=args.gff3,
        gff3_rna_patterns=args.gff3_RNA_patterns,
        gff3_genes_as_transcripts=args.gff3_genes_as_transcripts,
        trusted_sources=(
            set(args.trusted_sources.split(",")) if args.trusted_sources else None
        ),
        transcript_to_gene_map=args.transcript_to_gene_map,
        allele_to_gene_map=args.allele_to_gene_map,
        polyA=args.polyA,
        polyA_length=args.polyA_length,
        no_polyA_subset=args.no_polyA_subset,
        quiet=args.quiet,
    )
    fasta_files = args.reference_fasta_files.split(",")
    ts, ref = prepare_reference(fasta_files, args.reference_name, cfg)
    if not args.quiet:
        print(f"Prepared reference '{args.reference_name}': {ts.M} transcripts.")

    # aligner index builds (rsem-prepare-reference:166-204)
    from .aligners import (
        bowtie2_build_command,
        bowtie_build_command,
        hisat2_build_command,
        run_command,
        star_genome_generate_command,
    )

    log = (lambda *a: None) if args.quiet else print
    if args.use_bowtie:
        run_command(bowtie_build_command(args.bowtie_path,
                                         args.reference_name, args.quiet),
                    log=log)
    if args.bowtie2:
        run_command(bowtie2_build_command(args.bowtie2_path,
                                          args.reference_name,
                                          args.num_threads, args.quiet),
                    log=log)
    if args.star:
        if not args.gtf and not args.gff3:
            raise SystemExit(
                "STAR index builds need the genome + GTF annotation")
        run_command(
            star_genome_generate_command(
                args.star_path, args.reference_name, fasta_files,
                args.gtf or args.gff3, args.star_sjdboverhang,
                args.num_threads,
            ),
            log=log,
        )
    if args.hisat2_hca:
        run_command(hisat2_build_command(args.hisat2_path,
                                         args.reference_name,
                                         args.num_threads, args.quiet),
                    log=log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
