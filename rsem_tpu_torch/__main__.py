"""CLI: `python -m rsem_tpu_torch <command> [args...]`.

Counterpart of rsem_tpu/__main__.py for the commands ported so far: the
pipeline drivers, and the BAM-layer tools (host code on the port's own BAM
codec).
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
