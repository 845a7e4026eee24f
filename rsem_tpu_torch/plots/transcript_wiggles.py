"""Transcript wiggle plots (reference: rsem-plot-transcript-wiggles +
rsem-gen-transcript-plots).

Driver half (`plot_transcript_wiggles`) materializes the sorted transcript
BAM and readdepth files if absent (and the unique-read variants when
`show_unique` is set), mirroring rsem-plot-transcript-wiggles:40-66; the
plotting half (`gen_transcript_plots`) mirrors rsem-gen-transcript-plots:
per-transcript depth histograms 6 to a page, or one page per gene (or per
transcript in allele mode) with all member units, stacked unique/multi bars
under --show-unique.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_NROW, _NCOL = 3, 2  # plots per page for flat id lists
_PER_PAGE = _NROW * _NCOL


def _load_read_depth(path: str) -> Dict[str, Tuple[int, Optional[np.ndarray]]]:
    out: Dict[str, Tuple[int, Optional[np.ndarray]]] = {}
    with open(path) as f:
        for line in f:
            name, length, depths = line.rstrip("\n").split("\t")
            if depths == "NA":
                arr = None
            else:
                arr = np.array(depths.split(), dtype=np.float64)
            out[name] = (int(length), arr)
    return out


def _load_expr_units(path: str, composite_col: int):
    """Returns (unit_ids, {composite_id: [unit ids in file order]})."""
    units: List[str] = []
    groups: Dict[str, List[str]] = {}
    with open(path) as f:
        f.readline()
        for line in f:
            fields = line.rstrip("\n").split("\t")
            units.append(fields[0])
            groups.setdefault(fields[composite_col], []).append(fields[0])
    return units, groups


def _match_depth_ids(units: Sequence[str], depth_ids: Sequence[str]
                     ) -> Dict[str, str]:
    """Map expression unit ids to readdepth row ids. With --append-names the
    depth/BAM ids extend the unit id ('<id>_<name>'), so pair sorted orders
    positionally and require prefix equality (rsem-gen-transcript-plots:60-75).
    """
    if len(units) != len(depth_ids):
        raise ValueError(
            "The number of transcripts/alleles in the expression file does "
            "not equal the number in the readdepth file!"
        )
    su, sd = sorted(units), sorted(depth_ids)
    mapping = {}
    for u, d in zip(su, sd):
        if not d.startswith(u):
            raise ValueError(
                "Transcript/Allele IDs in the expression file do not match "
                f"the readdepth file ({u!r} vs {d!r})"
            )
        mapping[u] = d
    return mapping


def _plot_unit(ax, name: str, length: int, depth: Optional[np.ndarray],
               uniq_depth: Optional[np.ndarray], show_uniq: bool):
    wig = depth if depth is not None else np.zeros(length)
    x = np.arange(1, length + 1)
    if not show_uniq:
        ax.vlines(x, 0, wig, linewidth=0.8)
    else:
        uw = uniq_depth if uniq_depth is not None else np.zeros(length)
        extra = np.maximum(wig - uw, 0.0)
        ax.bar(x, uw, width=1.0, color="black", edgecolor="none")
        ax.bar(x, extra, bottom=uw, width=1.0, color="red", edgecolor="none")
    ax.set_title(name, fontsize=8)
    ax.tick_params(labelsize=6)
    ax.set_xlim(0, length + 1)


def gen_transcript_plots(
    sample_name: str,
    input_list: str,
    allele_specific: bool,
    id_type: int,
    show_uniq: bool,
    output_file: str,
    log=print,
) -> None:
    """id_type: 0 allele ids, 1 isoform ids, 2 gene ids."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    depth = _load_read_depth(f"{sample_name}.transcript.readdepth")
    uniq: Dict[str, Tuple[int, Optional[np.ndarray]]] = {}
    if show_uniq:
        uniq = _load_read_depth(f"{sample_name}.uniq.transcript.readdepth")
        if sorted(uniq) != sorted(depth):
            raise ValueError(
                "transcript/allele IDs in read depth and unique read depth "
                "files are not the same!"
            )

    expr_file = (f"{sample_name}.alleles.results" if allele_specific
                 else f"{sample_name}.isoforms.results")
    composite_col = 2 if (allele_specific and id_type == 2) else 1
    units, groups = _load_expr_units(expr_file, composite_col)
    unit2depth = _match_depth_ids(units, list(depth))

    is_composite = ((not allele_specific and id_type == 2)
                    or (allele_specific and id_type > 0))

    with open(input_list) as f:
        ids = [line.strip() for line in f if line.strip()]
    if not ids:
        raise ValueError("You should provide at least one ID.")

    valid: List[str] = []
    missing: List[str] = []
    for i in ids:
        ok = i in groups if is_composite else (i in unit2depth or i in depth)
        (valid if ok else missing).append(i)
    if missing:
        log("Warning: The following IDs are not in the RSEM indices and "
            "thus ignored: " + ", ".join(missing))
    if not valid:
        raise ValueError("There is no valid ID. Stopped.")

    def unit_row(unit: str):
        did = unit2depth.get(unit, unit)
        length, arr = depth[did]
        uarr = uniq[did][1] if (show_uniq and did in uniq) else None
        return did, length, arr, uarr

    with PdfPages(output_file) as pdf:
        if not is_composite:
            for page in range(0, len(valid), _PER_PAGE):
                chunk = valid[page : page + _PER_PAGE]
                fig, axes = plt.subplots(_NROW, _NCOL, figsize=(8.5, 11))
                flat = axes.ravel()
                for ax in flat[len(chunk):]:
                    ax.axis("off")
                for ax, unit in zip(flat, chunk):
                    did, length, arr, uarr = unit_row(unit)
                    _plot_unit(ax, did, length, arr, uarr, show_uniq)
                fig.tight_layout()
                pdf.savefig(fig)
                plt.close(fig)
        else:
            for cid in valid:
                members = groups[cid]
                n = len(members)
                ncol = max(1, int(math.floor(math.sqrt(n))))
                nrow = int(math.ceil(n / ncol))
                fig, axes = plt.subplots(nrow, ncol, figsize=(8.5, 11),
                                         squeeze=False)
                flat = axes.ravel()
                for ax in flat[n:]:
                    ax.axis("off")
                for ax, unit in zip(flat, members):
                    did, length, arr, uarr = unit_row(unit)
                    _plot_unit(ax, did, length, arr, uarr, show_uniq)
                fig.suptitle(cid)
                fig.tight_layout(rect=(0, 0, 1, 0.96))
                pdf.savefig(fig)
                plt.close(fig)
    log("Plots are generated!")


def plot_transcript_wiggles(
    sample_name: str,
    input_list: str,
    output_file: str,
    gene_list: bool = False,
    transcript_list: bool = False,
    show_unique: bool = False,
    log=print,
) -> None:
    from ..io.bamsort import sort_bam
    from ..io.wiggle import bam2readdepth
    from ..pipeline.bamtools import get_unique

    allele_specific = os.path.exists(f"{sample_name}.alleles.results")
    if transcript_list and not allele_specific:
        raise ValueError(
            "--transcript-list cannot be set if allele-specific reference "
            "is not built!"
        )
    if gene_list and transcript_list:
        raise ValueError(
            "--gene-list and --transcript-list cannot be set at the same time!"
        )

    sorted_bam = f"{sample_name}.transcript.sorted.bam"
    if not os.path.exists(sorted_bam):
        sort_bam(f"{sample_name}.transcript.bam", sorted_bam)
    rd = f"{sample_name}.transcript.readdepth"
    if not os.path.exists(rd):
        bam2readdepth(sorted_bam, rd)

    if show_unique:
        uniq_bam = f"{sample_name}.uniq.transcript.bam"
        if not os.path.exists(uniq_bam):
            get_unique(f"{sample_name}.transcript.bam", uniq_bam)
        uniq_sorted = f"{sample_name}.uniq.transcript.sorted.bam"
        if not os.path.exists(uniq_sorted):
            sort_bam(uniq_bam, uniq_sorted)
        uniq_rd = f"{sample_name}.uniq.transcript.readdepth"
        if not os.path.exists(uniq_rd):
            bam2readdepth(uniq_sorted, uniq_rd)

    if allele_specific:
        id_type = 0
        if transcript_list:
            id_type = 1
        if gene_list:
            id_type = 2
    else:
        id_type = 1
        if gene_list:
            id_type = 2

    gen_transcript_plots(sample_name, input_list, allele_specific, id_type,
                         show_unique, output_file, log=log)
