"""The numbers that decide `correct`: gaps between the program's values and
the reference's.

Each number is the largest, over the isoforms (or genes) of every result
judged, of |program - reference| / (|reference| + one read's worth), where
one read's worth is what a single read adds to that value: 1 for an
expected count, and for TPM and FPKM the value of one read on that isoform
(for a gene, on its member with the smallest such value). The floor keeps
isoforms that hold no reads from swamping the number with noise of no
consequence, while a gap of one read on any isoform reads about 1.

The reference stops where RSEM's rule stops it (every theta >= 1e-7 moved
by less than 1e-3, at least 20 rounds), so a program that stops early or
late is judged by how far its values then lie from RSEM's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .em import Expression

EPSILON = 1e-300
ISOFORM_NUMBERS = ("iso_count", "iso_tpm", "iso_fpkm")
GENE_NUMBERS = ("gene_count", "gene_tpm", "gene_fpkm")
NUMBERS = ISOFORM_NUMBERS + GENE_NUMBERS


def read_units(ref: Expression, gene_of: np.ndarray, n_genes: int
               ) -> Dict[str, np.ndarray]:
    """One read's worth of each value, per isoform [M] and per gene [G]."""
    eel = ref.eel[1:]
    ok = eel >= EPSILON
    c1 = float(ref.counts[1:][ok].sum())
    fsum = float(ref.fpkm[1:].sum())
    u_fpkm = np.where(ok, 1e9 / (np.where(ok, eel, 1.0) * max(c1, 1.0)),
                      1.0)
    u_tpm = np.where(ok, u_fpkm * 1e6 / max(fsum, EPSILON), 1.0)

    def gene_min(u):
        out = np.full(n_genes, np.inf)
        np.minimum.at(out, gene_of, u)
        return np.where(np.isfinite(out), out, 1.0)

    M = len(eel)
    return {"iso_count": np.ones(M), "iso_tpm": u_tpm, "iso_fpkm": u_fpkm,
            "gene_count": np.ones(n_genes), "gene_tpm": gene_min(u_tpm),
            "gene_fpkm": gene_min(u_fpkm)}


def reference_values(ref: Expression) -> Dict[str, np.ndarray]:
    return {"iso_count": ref.counts[1:], "iso_tpm": ref.tpm[1:],
            "iso_fpkm": ref.fpkm[1:], "gene_count": ref.gene_counts,
            "gene_tpm": ref.gene_tpm, "gene_fpkm": ref.gene_fpkm}


def gaps(values: Dict[str, np.ndarray], ref: Expression,
         units: Dict[str, np.ndarray]) -> Dict[str, float]:
    """The numbers of one result against the reference of its sample at
    RSEM's own stop. `values` holds the program's [M+1] isoform and [G]
    gene arrays under NUMBERS' names."""
    want = reference_values(ref)
    out = {}
    for name in NUMBERS:
        got = np.asarray(values[name], dtype=np.float64)
        if name in ISOFORM_NUMBERS:
            got = got[1:]
        if got.shape != want[name].shape or not np.all(np.isfinite(got)):
            out[name] = float("inf")
            continue
        out[name] = float(np.max(np.abs(got - want[name])
                                 / (np.abs(want[name]) + units[name]),
                                 initial=0.0))
    return out
