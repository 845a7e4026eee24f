"""rsem-run-ebseq / rsem-control-fdr drivers.

Output tables keep the reference's R write.table conventions (quoted row and
column names, tab separated, %.15g numbers) so rsem-control-fdr-style
consumers — including this package's own control_fdr — parse them unchanged
(EBSeq/rsem-for-ebseq-find-DE:34-74, rsem-control-fdr:24-56).
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence, TextIO

import numpy as np

from .ebseq import (
    EBMultiResult,
    EBTestResult,
    eb_multi_test,
    eb_test,
    get_patterns,
    median_norm,
)


def _fmt(x) -> str:
    if isinstance(x, str):
        return f'"{x}"'
    if x is None or (isinstance(x, float) and np.isnan(x)):
        return "NA"
    return f"{x:.15g}"


def _write_table(path: str, colnames: List[str], rownames: List[str],
                 rows: Sequence[Sequence]) -> None:
    with open(path, "w") as f:
        f.write("\t".join(f'"{c}"' for c in colnames) + "\n")
        for name, row in zip(rownames, rows):
            f.write('"' + name + '"\t' + "\t".join(_fmt(v) for v in row)
                    + "\n")


def read_data_matrix(path: str):
    """Read an rsem-generate-data-matrix output (R read.table format)."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        names: List[str] = []
        rows: List[List[float]] = []
        for line in f:
            fields = line.rstrip("\n").split("\t")
            names.append(fields[0].strip('"'))
            rows.append([float(x) for x in fields[1:]])
    return names, np.asarray(rows, dtype=np.float64)


def run_ebseq(
    data_matrix_file: str,
    conditions: Sequence[int],
    output_file: str,
    ngvector_file: Optional[str] = None,
    maxround: int = 5,
) -> None:
    """conditions: replicate count per condition, e.g. [3, 3] or [2, 3, 3]."""
    names, data = read_data_matrix(data_matrix_file)
    num_reps = list(conditions)
    n = data.shape[1]
    if sum(num_reps) != n:
        raise ValueError(
            "Total number of replicates given does not match the number of "
            "columns from the data matrix!"
        )
    cond = np.concatenate([
        np.full(r, i) for i, r in enumerate(num_reps)
    ])
    sizes = median_norm(data)
    ng = None
    if ngvector_file:
        ng = np.loadtxt(ngvector_file, dtype=np.int64).reshape(-1)
        if len(ng) != len(data):
            raise ValueError("ngvector length does not match the matrix")

    if len(num_reps) == 2:
        res = eb_test(data, cond, sizes=sizes, ng_vector=ng,
                      maxround=maxround, names=names)
        order = np.argsort(-res.ppde, kind="stable")
        rows = [
            [res.ppee[i], res.ppde[i], res.post_fc[i], res.real_fc[i],
             res.c1_mean[i], res.c2_mean[i]]
            for i in order
        ]
        _write_table(
            output_file,
            ["PPEE", "PPDE", "PostFC", "RealFC", "C1Mean", "C2Mean"],
            [res.names[i] for i in order],
            rows,
        )
    else:
        res = eb_multi_test(data, cond, sizes=sizes, ng_vector=ng,
                            maxround=maxround, names=names)
        K = res.pp.shape[1]
        with np.errstate(invalid="ignore"):
            ppde = np.where(np.isnan(res.ppde), -np.inf, res.ppde)
        order = np.argsort(-ppde, kind="stable")
        pat_names = [f"Pattern{i+1}" for i in range(K)]
        rows = []
        for i in order:
            row = [res.pp[i, kk] for kk in range(K)]
            row.append(res.map_pattern[i])
            row.append(res.ppde[i])
            rows.append(row)
        _write_table(
            output_file,
            pat_names + ["MAP", "PPDE"],
            [res.names[i] for i in order],
            rows,
        )
        cond_names = [f"C{i+1}" for i in range(len(num_reps))]
        _write_table(
            f"{output_file}.pattern",
            cond_names,
            pat_names,
            res.patterns.tolist(),
        )
        _write_table(
            f"{output_file}.condmeans",
            cond_names,
            [res.names[i] for i in order],
            [res.cond_means[i].tolist() for i in order],
        )

    # normalized matrix (column names = sample columns of the input)
    with open(data_matrix_file) as f:
        sample_cols = [c.strip('"') for c in
                       f.readline().rstrip("\n").split("\t")[1:]]
    _write_table(
        f"{output_file}.normalized_data_matrix",
        sample_cols,
        names,
        res.norm_mat.tolist(),
    )


def control_fdr(input_file: str, fdr: float, output_file: str,
                soft: bool = False, log=print) -> int:
    """Filter rsem-run-ebseq output at the given FDR (rsem-control-fdr)."""
    with open(input_file) as f:
        header = f.readline().rstrip("\n")
        columns = header.split("\t")
        try:
            pos = columns.index('"PPDE"')
        except ValueError:
            raise ValueError("Cannot find column PPDE!")
        pos += 1  # data rows carry the quoted row name first

        n = 0
        total = 0.0
        with open(output_file, "w") as out:
            out.write(header + "\n")
            for line in f:
                fields = line.rstrip("\n").split("\t")
                try:
                    ppee = 1.0 - float(fields[pos])
                except ValueError:
                    break
                if soft:
                    if total + ppee > fdr * (n + 1):
                        break
                    total += ppee
                else:
                    if ppee > fdr:
                        break
                n += 1
                out.write(line.rstrip("\n") + "\n")
    log(f"There are {n} genes/transcripts reported at FDR = {fdr:g}.")
    return n
