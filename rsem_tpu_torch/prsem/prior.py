"""Partitioned Dirichlet-multinomial prior learning
(process-rnaseq.R:644-770).

The training transcripts' posterior mean counts are modeled as one
multinomial draw whose probabilities follow a Dirichlet with a shared
concentration alpha_k per partition; the ML alphas (L-BFGS-B with analytic
gradient, bounds [1e-4, 1e4], R getFitByMLDM) become the per-isoform
pseudo-counts handed to the Gibbs sampler. Informativeness is a one-sided
Wilcoxon rank-sum on peak vs. no-peak training counts (genPriorByTSSPeak,
R:465-469)."""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy.optimize import minimize
from scipy.special import digamma, gammaln
from scipy.stats import mannwhitneyu

INFORMATIVE_DATA_MAX_P_VALUE = 0.01  # pRSEM/Param.py:16


def dm_log_likelihood(alpha: np.ndarray, counts: np.ndarray,
                      partition: np.ndarray) -> float:
    """R partitioned_log_likelihood (process-rnaseq.R:682-692).
    alpha: [K]; counts: [G]; partition: [G] ints in [0, K)."""
    comp = np.bincount(partition, minlength=len(alpha)).astype(np.float64)
    N = counts.sum()
    a_dot = float(comp @ alpha)
    return float(
        gammaln(N + 1) - gammaln(counts + 1).sum()
        + gammaln(a_dot) - gammaln(N + a_dot)
        + gammaln(counts + alpha[partition]).sum()
        - float(comp @ gammaln(alpha))
    )


def _dm_gradient(alpha: np.ndarray, counts: np.ndarray,
                 partition: np.ndarray) -> np.ndarray:
    comp = np.bincount(partition, minlength=len(alpha)).astype(np.float64)
    N = counts.sum()
    a_dot = float(comp @ alpha)
    per_row = digamma(counts + alpha[partition])
    per_part = np.bincount(partition, weights=per_row, minlength=len(alpha))
    return comp * (digamma(a_dot) - digamma(N + a_dot) - digamma(alpha)) \
        + per_part


def fit_partitioned_dm(counts: np.ndarray, partition: np.ndarray,
                       n_parts: int) -> Tuple[np.ndarray, float]:
    """Maximize the partitioned DM likelihood; returns (alpha[K], logL)."""
    counts = np.asarray(counts, dtype=np.float64)
    partition = np.asarray(partition, dtype=np.int64)
    x0 = np.ones(n_parts)
    res = minimize(
        lambda a: -dm_log_likelihood(a, counts, partition),
        x0,
        jac=lambda a: -_dm_gradient(a, counts, partition),
        method="L-BFGS-B",
        bounds=[(1e-4, 1e4)] * n_parts,
    )
    return np.asarray(res.x), float(-res.fun)


def informative_pvalue(with_peak_counts: np.ndarray,
                       without_peak_counts: np.ndarray) -> float:
    """P(peak counts > no-peak counts) one-sided Wilcoxon rank-sum
    (R wilcox.test alternative='greater')."""
    if len(with_peak_counts) == 0 or len(without_peak_counts) == 0:
        return 1.0
    return float(
        mannwhitneyu(with_peak_counts, without_peak_counts,
                     alternative="greater").pvalue
    )


def write_prior_file(path: str, priors: np.ndarray,
                     trids: Sequence[str]) -> None:
    """One line per isoform in .ti order: `<prior>  # <trid>` — the format
    rsem-run-gibbs --prior parses (leading double, rest ignored;
    Gibbs.cpp:171-184, R genPriorByTSSPeak write.table sep='  # ')."""
    with open(path, "w") as f:
        for p, t in zip(priors, trids):
            f.write(f"{p:.15g}  # {t}\n")


def read_prior_file(path: str, M: int) -> np.ndarray:
    """[M+1] pseudo-counts (index 0 = noise isoform, always 0)."""
    out = np.zeros(M + 1, dtype=np.float64)
    with open(path) as f:
        for i in range(1, M + 1):
            line = f.readline()
            if not line:
                raise ValueError(f"prior file {path} has fewer than {M} lines")
            out[i] = float(line.split()[0])
    return out
