"""rsem-prepare-reference equivalent: one call building every reference artifact.

Pipeline (reference: rsem-prepare-reference:126-204):
  [gff3 -> gtf] -> extract (GTF+genome) | synthesis (transcript FASTA)
  -> preref (.seq / .idx.fa / .n2g.idx.fa with poly(A) + masks)

Aligner index builds (bowtie/STAR/...) run outside this function
(pipeline/prepare_reference.py drives them); `.idx.fa`/`.n2g.idx.fa` are
emitted so any aligner's index build can run on them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..constants import DEFAULT_POLYA_LEN
from .extract import (
    extract_reference_transcripts,
    load_allele_to_gene_map,
    load_transcript_to_gene_map,
)
from .reference import PolyARules, Reference, load_polya_exceptions
from .synthesis import synthesize_reference_transcripts
from .transcripts import Transcripts


@dataclass
class PrepareConfig:
    """Mirrors rsem-prepare-reference's option surface
    (reference: rsem-prepare-reference:52-75)."""

    gtf: Optional[str] = None
    gff3: Optional[str] = None
    gff3_rna_patterns: str = "mRNA"
    gff3_genes_as_transcripts: bool = False
    trusted_sources: Optional[Set[str]] = None
    transcript_to_gene_map: Optional[str] = None
    allele_to_gene_map: Optional[str] = None
    polyA: bool = False
    polyA_length: int = DEFAULT_POLYA_LEN
    no_polyA_subset: Optional[str] = None
    quiet: bool = False


def prepare_reference(
    fasta_files: Sequence[str],
    ref_name: str,
    config: Optional[PrepareConfig] = None,
) -> Tuple[Transcripts, Reference]:
    """Build all reference artifacts rooted at `ref_name`.

    fasta_files: genome FASTAs when a GTF/GFF3 is given, otherwise transcript
    FASTAs. Returns (transcripts, reference).
    """
    cfg = config or PrepareConfig()

    gtf_path = cfg.gtf
    if cfg.gff3 is not None:
        assert gtf_path is None, "Specify --gtf or --gff3, not both"
        from .gff3 import gff3_to_gtf

        gtf_path = f"{ref_name}.gtf"
        gff3_to_gtf(
            cfg.gff3,
            gtf_path,
            rna_patterns=cfg.gff3_rna_patterns,
            genes_as_transcripts=cfg.gff3_genes_as_transcripts,
        )

    tid2gid: Optional[Dict[str, str]] = None
    if cfg.transcript_to_gene_map is not None:
        tid2gid = load_transcript_to_gene_map(cfg.transcript_to_gene_map)

    if gtf_path is not None:
        assert cfg.allele_to_gene_map is None, (
            "Allele-specific mode requires transcript FASTA input"
        )
        ts, _seqs = extract_reference_transcripts(
            ref_name, gtf_path, fasta_files, cfg.trusted_sources, tid2gid
        )
    else:
        allele_map = None
        if cfg.allele_to_gene_map is not None:
            allele_map = load_allele_to_gene_map(cfg.allele_to_gene_map)
        ts, _seqs = synthesize_reference_transcripts(
            ref_name, fasta_files, tid2gid, allele_map
        )

    # preref: poly(A) padding + canonicalization + masks (preRef.cpp:64-87).
    # Poly(A) choice: 0 pad-all, 1 none, 2 all-except (PolyARules.h).
    if not cfg.polyA:
        rules = PolyARules(choice=1)
    elif cfg.no_polyA_subset is not None:
        rules = PolyARules(
            choice=2,
            polya_len=cfg.polyA_length,
            exceptions=load_polya_exceptions(cfg.no_polyA_subset),
        )
    else:
        rules = PolyARules(choice=0, polya_len=cfg.polyA_length)

    ref = Reference.from_fasta(f"{ref_name}.transcripts.fa", rules)
    ref.save_seq(f"{ref_name}.seq")
    ref.save_idx_fasta(f"{ref_name}.idx.fa", n2g=False)
    ref.save_idx_fasta(f"{ref_name}.n2g.idx.fa", n2g=True)
    return ts, ref
