"""Model diagnostic plots (reference: rsem-plot-model R script, lines 22-167).

Reads `<sample>.stat/<token>.model` and `<token>.cnt` and renders, page by
page into one PDF: fragment length distribution, read length distribution
(if estimated), RSPD (if estimated), sequencing-error diagnostics (quality
models: observed vs. Phred quality per reference base; no-qual models:
positional error percentage per reference base), and alignment statistics
(histogram + pie).
"""

from __future__ import annotations

import os

import numpy as np

_BASES = ("A", "C", "G", "T")
_BASE_STYLES = (("black", "s"), ("red", "o"), ("green", "^"), ("blue", "+"))


def _stat_paths(sample_name: str):
    token = os.path.basename(sample_name)
    stat_dir = f"{sample_name}.stat"
    if not os.path.isdir(stat_dir):
        raise FileNotFoundError(f"directory does not exist: {stat_dir}")
    return f"{stat_dir}/{token}.model", f"{stat_dir}/{token}.cnt"


def _len_dist_page(pdf, plt, lend, title: str, xlabel: str):
    x = np.arange(lend.lb + 1, lend.ub + 1)
    y = np.asarray(lend.pdf[1:], dtype=np.float64)
    total = y.sum()
    if total <= 0:
        return
    mode = int(x[np.argmax(y)])
    mean = float(np.average(x, weights=y))
    std = float(np.sqrt(np.average((x - mean) ** 2, weights=y)))
    fig, ax = plt.subplots()
    ax.vlines(x, 0, y, linewidth=1.0)
    ax.axvline(mode, color="red", linestyle="--")
    ax.set_title(title)
    ax.set_xlabel(
        f"{xlabel}\nMode = {mode}, Mean = {mean:.1f}, and Std = {std:.1f}"
    )
    ax.set_ylabel("Probability")
    pdf.savefig(fig)
    plt.close(fig)


def _rspd_page(pdf, plt, rspd):
    y = np.asarray(rspd.pdf[1 : rspd.B + 1], dtype=np.float64)
    fig, ax = plt.subplots()
    ax.bar(np.arange(1, rspd.B + 1), y, width=1.0, align="center",
           edgecolor="none", color="dimgrey")
    ax.set_title("Read Start Position Distribution")
    ax.set_xlabel("Bin #")
    ax.set_ylabel("Probability")
    ax.set_xticks(np.arange(1, rspd.B + 1))
    ax.tick_params(axis="x", labelsize=7)
    pdf.savefig(fig)
    plt.close(fig)


def _qual_error_page(pdf, plt, p: np.ndarray):
    """Observed quality vs Phred quality per reference base.

    p: [QSIZE, NCODES, NCODES] conditional read-base probabilities; the
    observed quality of base b at Phred score q is -10*log10(1 - p[q,b,b])
    (rsem-plot-model:87-113)."""
    xs, series = [], [[] for _ in range(4)]
    for q in range(p.shape[0]):
        block = p[q, :4, :]
        if block.sum() < 1e-8:
            continue
        xs.append(q)
        for b in range(4):
            row = p[q, b, :]
            if row.sum() < 1e-8:
                series[b].append(np.nan)
            else:
                series[b].append(-10.0 * np.log10(max(1.0 - row[b], 1e-300)))
    if not xs:
        return
    fig, ax = plt.subplots()
    for b, (color, marker) in enumerate(_BASE_STYLES):
        ax.plot(xs, series[b], color=color, marker=marker,
                markerfacecolor="none", linewidth=1, label=_BASES[b])
    ax.set_title("Observed Quality vs. Phred Quality Score")
    ax.set_xlabel("Phred Quality Score")
    ax.set_ylabel("Observed Quality")
    ax.legend(loc="upper left")
    pdf.savefig(fig)
    plt.close(fig)


def _pos_error_page(pdf, plt, p: np.ndarray):
    """Positional sequencing error percentage per reference base.

    p: [maxL, NCODES, NCODES]; error% at position i for ref base b is
    (1 - p[i,b,b]) * 100 (rsem-plot-model:115-141)."""
    xs, series = [], [[] for _ in range(4)]
    for i in range(p.shape[0]):
        block = p[i, :4, :]
        if block.sum() < 1e-8:
            continue
        xs.append(i + 1)
        for b in range(4):
            row = p[i, b, :]
            if row.sum() < 1e-8:
                series[b].append(np.nan)
            else:
                series[b].append((1.0 - row[b]) * 100.0)
    if not xs:
        return
    fig, ax = plt.subplots()
    for b, (color, marker) in enumerate(_BASE_STYLES):
        ax.plot(xs, series[b], color=color, marker=marker, markersize=3,
                markerfacecolor="none", linewidth=1, label=_BASES[b])
    ax.set_title("Position vs. Percentage Sequence Error")
    ax.set_xlabel("Position")
    ax.set_ylabel("Percentage of Sequencing Error")
    ax.legend(loc="upper left")
    pdf.savefig(fig)
    plt.close(fig)


def _alignment_stats_page(pdf, plt, cnt):
    """Alignments-per-read histogram with a pie inset
    (rsem-plot-model:146-167)."""
    hist = dict(cnt.hist or {})
    upper = max(hist) if hist else 1
    heights = np.zeros(upper + 2, dtype=np.float64)
    heights[0] = cnt.N0
    for k, v in hist.items():
        heights[k] = v
    heights[upper + 1] = cnt.N2
    labels = [str(i) for i in range(upper + 1)] + ["Inf"]
    colors = ["green", "blue"] + ["dimgrey"] * (upper - 1) + ["red"]

    fig, ax = plt.subplots()
    ax.bar(np.arange(len(heights)), heights, width=1.0, color=colors,
           edgecolor="none")
    ax.set_xticks(np.arange(len(heights)))
    ax.set_xticklabels(labels, fontsize=7)
    ax.set_xlabel("Number of alignments per read")
    ax.set_ylabel("Number of reads")
    ax.set_title("Alignment statistics")

    pie_values = np.array([
        heights[0],
        heights[1],
        heights[2 : upper + 1].sum(),
        heights[upper + 1],
    ])
    total = pie_values.sum()
    if total > 0:
        pie_names = ("Unalignable", "Unique", "Multi", "Filtered")
        pie_labels = [
            f"{n} {v * 100.0 / total:.0f}%" for n, v in zip(pie_names, pie_values)
        ]
        inset = fig.add_axes([0.45, 0.45, 0.45, 0.45])
        inset.pie(pie_values, labels=pie_labels,
                  colors=("green", "blue", "dimgrey", "red"),
                  counterclock=False, startangle=90,
                  textprops={"fontsize": 8})
    pdf.savefig(fig)
    plt.close(fig)


def plot_model(sample_name: str, output_file: str) -> None:
    """Render model diagnostic plots into output_file (PDF)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.backends.backend_pdf import PdfPages

    from ..io.hits import CntStats
    from ..model.generative import GenerativeModel

    model_path, cnt_path = _stat_paths(sample_name)
    model = GenerativeModel.read(model_path)
    cnt = CntStats.load(cnt_path)

    with PdfPages(output_file) as pdf:
        _len_dist_page(pdf, plt, model.gld, "Fragment Length Distribution",
                       "Fragment Length")
        if model.mld is not None:
            _len_dist_page(pdf, plt, model.mld, "Read Length Distribution",
                           "Read Length")
        if model.rspd.est_rspd:
            _rspd_page(pdf, plt, model.rspd)
        p = np.asarray(model.pro.p, dtype=np.float64)
        if model.spec.model_type in (1, 3):
            _qual_error_page(pdf, plt, p)
        else:
            _pos_error_page(pdf, plt, p)
        _alignment_stats_page(pdf, plt, cnt)
