"""External aligner command construction and execution.

Builds the exact alignment / index commands the reference drives
(rsem-calculate-expression:391-565, rsem-prepare-reference:166-204):
Bowtie, Bowtie2, STAR (ENCODE3 parameters + --quantMode TranscriptomeSAM),
and HISAT2-HCA. Command construction is pure (unit-testable without the
binaries); `run_alignment` shells out and converts SAM to BAM with this
package's own codec when samtools is unavailable.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from dataclasses import dataclass
from typing import List, Optional


@dataclass
class AlignerConfig:
    aligner: str = "bowtie"  # bowtie | bowtie2 | star | hisat2-hca
    n_threads: int = 1
    no_qualities: bool = False
    phred33: bool = True
    phred64: bool = False
    solexa: bool = False
    probF: float = 0.5
    quiet: bool = False
    # bowtie (rsem-calculate-expression:40-47)
    bowtie_path: str = ""
    bowtie_n: int = 2
    bowtie_e: int = 99999999
    bowtie_m: int = 200
    bowtie_chunkmbs: int = 0
    seed_length: int = 25
    # bowtie2 (:48-52)
    bowtie2_path: str = ""
    bowtie2_mismatch_rate: float = 0.1
    bowtie2_k: int = 200
    bowtie2_sensitivity_level: str = "sensitive"
    # paired-end fragment bounds (bowtie -I/-X)
    fragment_length_min: int = 1
    fragment_length_max: int = 1000
    # star (:455-506)
    star_path: str = ""
    star_gzipped_read_file: bool = False
    star_bzipped_read_file: bool = False
    # hisat2 (:507-539)
    hisat2_path: str = ""


def _prefix(path: str, binary: str) -> str:
    return os.path.join(path, binary) if path else binary


def _quals_flag(cfg: AlignerConfig, style: str) -> str:
    """style: 'bowtie' uses --phred33-quals/--phred64-quals; 'dash2' uses
    --phred33/--phred64 (bowtie2/hisat2); both use --solexa-quals."""
    if cfg.phred64:
        return "--phred64-quals" if style == "bowtie" else "--phred64"
    if cfg.solexa:
        return "--solexa-quals"
    return "--phred33-quals" if style == "bowtie" else "--phred33"


def bowtie_command(cfg: AlignerConfig, ref_name: str, sample_name: str,
                   imd_name: str, mate1_list: str,
                   mate2_list: Optional[str] = None) -> str:
    """rsem-calculate-expression:392-420."""
    c = [_prefix(cfg.bowtie_path, "bowtie")]
    c.append("-f" if cfg.no_qualities else "-q")
    c.append(_quals_flag(cfg, "bowtie"))
    c.append(f"-n {cfg.bowtie_n} -e {cfg.bowtie_e} -l {cfg.seed_length}")
    if mate2_list:
        c.append(f"-I {cfg.fragment_length_min} -X {cfg.fragment_length_max}")
    if cfg.bowtie_chunkmbs > 0:
        c.append(f"--chunkmbs {cfg.bowtie_chunkmbs}")
    if cfg.probF == 1.0:
        c.append("--norc")
    elif cfg.probF == 0.0:
        c.append("--nofw")
    c.append(f"-p {cfg.n_threads} -a -m {cfg.bowtie_m} -S")
    if cfg.quiet:
        c.append("--quiet")
    c.append(ref_name)
    if mate2_list:
        c.append(f"-1 {mate1_list} -2 {mate2_list}")
    else:
        c.append(mate1_list)
    c.append(f"2> {sample_name}.log")
    return " ".join(c)


def bowtie2_command(cfg: AlignerConfig, ref_name: str, sample_name: str,
                    imd_name: str, mate1_list: str,
                    mate2_list: Optional[str] = None) -> str:
    """rsem-calculate-expression:421-454."""
    c = [_prefix(cfg.bowtie2_path, "bowtie2")]
    c.append("-f" if cfg.no_qualities else "-q")
    c.append(_quals_flag(cfg, "dash2"))
    lvl = cfg.bowtie2_sensitivity_level
    c.append({
        "very_fast": "--very-fast",
        "fast": "--fast",
        "sensitive": "--sensitive",
    }.get(lvl, "--very-sensitive"))
    c.append("--dpad 0 --gbar 99999999 --mp 1,1 --np 1 "
             f"--score-min L,0,-{cfg.bowtie2_mismatch_rate}")
    if mate2_list:
        c.append(f"-I {cfg.fragment_length_min} -X {cfg.fragment_length_max} "
                 "--no-mixed --no-discordant")
    if cfg.probF == 1.0:
        c.append("--norc")
    elif cfg.probF == 0.0:
        c.append("--nofw")
    c.append(f"-p {cfg.n_threads} -k {cfg.bowtie2_k}")
    if cfg.quiet:
        c.append("--quiet")
    c.append(f"-x {ref_name}")
    if mate2_list:
        c.append(f"-1 {mate1_list} -2 {mate2_list}")
    else:
        c.append(f"-U {mate1_list}")
    c.append(f"2> {sample_name}.log")
    return " ".join(c)


def star_command(cfg: AlignerConfig, ref_name: str, sample_name: str,
                 imd_name: str, mate1_list: str,
                 mate2_list: Optional[str] = None) -> str:
    """ENCODE3 parameters (rsem-calculate-expression:455-506); transcript
    BAM lands at <imd_name>Aligned.toTranscriptome.out.bam."""
    genome_dir = os.path.dirname(ref_name) or "."
    c = [
        _prefix(cfg.star_path, "STAR"),
        f"--genomeDir {genome_dir}",
        "--outSAMunmapped Within",
        "--outFilterType BySJout",
        "--outSAMattributes NH HI AS NM MD",
        "--outFilterMultimapNmax 20",
        "--outFilterMismatchNmax 999",
        "--outFilterMismatchNoverLmax 0.04",
        "--alignIntronMin 20",
        "--alignIntronMax 1000000",
        "--alignMatesGapMax 1000000",
        "--alignSJoverhangMin 8",
        "--alignSJDBoverhangMin 1",
        "--sjdbScore 1",
        f"--runThreadN {cfg.n_threads}",
        "--genomeLoad NoSharedMemory",
        "--outSAMtype BAM Unsorted",
        "--quantMode TranscriptomeSAM",
        "--outSAMheaderHD @HD VN:1.4 SO:unsorted",
        f"--outFileNamePrefix {imd_name}",
    ]
    if cfg.star_gzipped_read_file:
        c.append("--readFilesCommand zcat")
    elif cfg.star_bzipped_read_file:
        c.append("--readFilesCommand bzip2 -c")
    if mate2_list:
        c.append(f"--readFilesIn {mate1_list} {mate2_list}")
    else:
        c.append(f"--readFilesIn {mate1_list}")
    return " ".join(c)


def hisat2_hca_command(cfg: AlignerConfig, ref_name: str, sample_name: str,
                       imd_name: str, mate1_list: str,
                       mate2_list: Optional[str] = None) -> str:
    """HISAT2 with Human Cell Atlas settings
    (rsem-calculate-expression:507-539)."""
    token = os.path.basename(sample_name)
    c = [_prefix(cfg.hisat2_path, "hisat2")]
    c.append("-f" if cfg.no_qualities else "-q")
    c.append(_quals_flag(cfg, "dash2"))
    c.append(
        f"--rg-id={token} --rg SM:{token} --rg LB:{token} --rg PL:ILLUMINA "
        f"--rg PU:{token} --new-summary --summary-file {sample_name}.log "
        f"--met-file {sample_name}.hisat2.met.txt --met 5 "
        "--mp 1,1 --np 1 --score-min L,0,-0.1 "
        "--rdg 99999999,99999999 --rfg 99999999,99999999 "
        "--no-spliced-alignment --no-softclip --seed 12345"
    )
    if mate2_list:
        c.append("--no-mixed --no-discordant")
    if cfg.probF == 1.0:
        c.append("--norc")
    elif cfg.probF == 0.0:
        c.append("--nofw")
    if cfg.quiet:
        c.append("--quiet")
    c.append(f"-p {cfg.n_threads} -k 10 --secondary")
    c.append(f"-x {ref_name}")
    if mate2_list:
        c.append(f"-1 {mate1_list} -2 {mate2_list}")
    else:
        c.append(f"-U {mate1_list}")
    return " ".join(c)


def build_alignment_command(cfg: AlignerConfig, ref_name: str,
                            sample_name: str, imd_name: str,
                            mate1_list: str,
                            mate2_list: Optional[str] = None) -> str:
    fn = {
        "bowtie": bowtie_command,
        "bowtie2": bowtie2_command,
        "star": star_command,
        "hisat2-hca": hisat2_hca_command,
    }.get(cfg.aligner)
    if fn is None:
        raise ValueError(f"unknown aligner {cfg.aligner!r}")
    return fn(cfg, ref_name, sample_name, imd_name, mate1_list, mate2_list)


# ---- prepare-reference index builds (rsem-prepare-reference:166-204) ---- #
def bowtie_build_command(path: str, ref_name: str, quiet: bool = False) -> str:
    c = [_prefix(path, "bowtie-build"), "-f"]
    if quiet:
        c.append("-q")
    c.append(f"{ref_name}.n2g.idx.fa {ref_name}")
    return " ".join(c)


def bowtie2_build_command(path: str, ref_name: str, n_threads: int = 1,
                          quiet: bool = False) -> str:
    c = [_prefix(path, "bowtie2-build"), "-f"]
    if n_threads > 1:
        c.append(f"--threads {n_threads}")
    if quiet:
        c.append("-q")
    c.append(f"{ref_name}.idx.fa {ref_name}")
    return " ".join(c)


def star_genome_generate_command(path: str, ref_name: str, fasta_files: List[str],
                                 gtf_file: str, sjdboverhang: int = 100,
                                 n_threads: int = 1) -> str:
    out_dir = os.path.dirname(ref_name) or "."
    return " ".join([
        _prefix(path, "STAR"),
        f"--runThreadN {n_threads}",
        "--runMode genomeGenerate",
        f"--genomeDir {out_dir}",
        f"--genomeFastaFiles {' '.join(fasta_files)}",
        f"--sjdbGTFfile {gtf_file}",
        f"--sjdbOverhang {sjdboverhang}",
        f"--outFileNamePrefix {ref_name}",
    ])


def hisat2_build_command(path: str, ref_name: str, n_threads: int = 1,
                         quiet: bool = False) -> str:
    c = [_prefix(path, "hisat2-build"), "-f"]
    if n_threads > 1:
        c.append(f"-p {n_threads}")
    if quiet:
        c.append("-q")
    c.append(f"{ref_name}.idx.fa {ref_name}")
    return " ".join(c)


# ---- execution ---------------------------------------------------------- #
def _aligner_binary(command: str) -> str:
    return command.split()[0]


def run_command(command: str, log=print) -> None:
    binary = _aligner_binary(command)
    if shutil.which(binary) is None:
        raise FileNotFoundError(
            f"aligner binary {binary!r} not found on PATH; install it, pass "
            "its --*-path option, or align externally and use --alignments"
        )
    log(f"Running: {command}")
    rc = subprocess.call(command, shell=True)
    if rc != 0:
        raise RuntimeError(f'"{command}" failed! exit code {rc}')


def _degzip_list(file_list: str, imd_name: str, tag: str) -> str:
    """Decompress any .gz entries of a comma-separated read-file list into
    `<imd>.<tag>.<i>.fq` and return the rewritten list."""
    import gzip
    import shutil

    out = []
    for i, f in enumerate(file_list.split(",")):
        if f.endswith(".gz"):
            plain = f"{imd_name}.{tag}.{i}.fq"
            with gzip.open(f, "rb") as src, open(plain, "wb") as dst:
                shutil.copyfileobj(src, dst)
            out.append(plain)
        else:
            out.append(f)
    return ",".join(out)


def run_alignment(cfg: AlignerConfig, ref_name: str, sample_name: str,
                  imd_name: str, mate1_list: str,
                  mate2_list: Optional[str] = None, log=print) -> str:
    """Run the aligner; returns the transcript SAM/BAM path for parsing.

    Bowtie/Bowtie2/HISAT2 write SAM to <imd>.sam (the reference pipes
    through `samtools view -b`; this framework's BAM parser accepts SAM
    directly, so the pipe is unnecessary). STAR writes its own BAM.

    Gzipped read files: bowtie2/hisat2 read .gz natively; classic bowtie
    does not, so its inputs are decompressed next to the intermediates
    first (the reference requires manual decompression there)."""
    if cfg.aligner == "bowtie":
        mate1_list = _degzip_list(mate1_list, imd_name, "m1")
        if mate2_list:
            mate2_list = _degzip_list(mate2_list, imd_name, "m2")
    command = build_alignment_command(cfg, ref_name, sample_name, imd_name,
                                      mate1_list, mate2_list)
    if cfg.aligner == "star":
        run_command(command, log=log)
        star_tr = f"{imd_name}Aligned.toTranscriptome.out.bam"
        out = f"{imd_name}.bam"
        os.replace(star_tr, out)
        genome_bam = f"{imd_name}Aligned.out.bam"
        if os.path.exists(genome_bam):
            os.remove(genome_bam)
        log_final = f"{imd_name}Log.final.out"
        if os.path.exists(log_final):
            os.replace(log_final, f"{sample_name}.log")
        return out
    out = f"{imd_name}.sam"
    run_command(f"{command} > {out}" if "2>" in command
                else f"{command} > {out}", log=log)
    return out
