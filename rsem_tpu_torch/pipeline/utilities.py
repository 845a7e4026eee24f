"""Small user-facing utilities: data matrix, Trinity gene map, RefSeq
primary-assembly extraction (reference: rsem-generate-data-matrix,
extract-transcript-to-gene-map-from-trinity,
rsem-refseq-extract-primary-assembly).
"""

from __future__ import annotations

import sys
from typing import List, Sequence, TextIO


def generate_data_matrix(result_files: Sequence[str], out: TextIO):
    """Join the expected_count columns of N *.results files into a matrix
    (rsem-generate-data-matrix). Column 4 for genes/isoforms, 5 for
    alleles.results."""
    if not result_files:
        raise ValueError("need at least one results file")
    offset = 5 if result_files[0].endswith("alleles.results") else 4

    ids_ref: List[str] = []
    columns: List[List[str]] = []
    for path in result_files:
        ids: List[str] = []
        ecs: List[str] = []
        with open(path) as f:
            f.readline()  # header
            for line in f:
                fields = line.rstrip("\n").split("\t")
                ids.append(f'"{fields[0]}"')
                ecs.append(fields[offset])
        if not ids:
            raise ValueError(f"Nothing detected in {path}; missing or empty?")
        if not ids_ref:
            ids_ref = ids
        elif ids != ids_ref:
            raise ValueError("Row ids differ between samples!")
        columns.append(ecs)

    colnames = [
        f'"{p[2:] if p.startswith("./") else p}"' for p in result_files
    ]
    out.write("\t" + "\t".join(colnames) + "\n")
    for i, rid in enumerate(ids_ref):
        out.write(rid + "\t" + "\t".join(c[i] for c in columns) + "\n")


def extract_trinity_gene_map(fasta_path: str, map_path: str, log=print):
    """gene_id = transcript_id up to the last '_'
    (extract-transcript-to-gene-map-from-trinity)."""
    with open(fasta_path) as fin, open(map_path, "w") as fout:
        tid = None
        has_seq = False

        def emit():
            if tid is None:
                return
            if not has_seq:
                log(f"Warning: Fasta entry {tid} has an empty sequence, it "
                    "is omitted.")
                return
            head = tid.split(" ")[0]
            pos = head.rfind("_")
            gid = head[:pos] if pos >= 0 else head
            fout.write(f"{gid}\t{head}\n")

        for line in fin:
            line = line.rstrip("\n")
            if line.startswith(">"):
                emit()
                tid = line[1:]
                has_seq = False
            elif line:
                has_seq = True
        emit()


def refseq_extract_primary_assembly(input_path: str, output_path: str):
    """Keep only FASTA entries whose header mentions 'Primary Assembly'
    (rsem-refseq-extract-primary-assembly)."""
    write_out = True
    with open(input_path) as fin, open(output_path, "w") as fout:
        for line in fin:
            line = line.strip()
            if line.startswith(">"):
                write_out = line.rfind("Primary Assembly") >= 0
            if write_out:
                fout.write(line + "\n")
