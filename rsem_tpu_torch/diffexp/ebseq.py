"""Native EBSeq: empirical-Bayes differential expression on count matrices.

A NumPy/SciPy reimplementation of the algorithm of the vendored EBSeq 1.2.0 R
package the reference drives through Rscript (EBSeq/rsem-for-ebseq-find-DE,
EBSeq_1.2.0.tar.gz: R/EBTest.R, R/EBMultiTest.R, R/LogN.R, R/f0.R,
R/Likefun.R, R/MedianNorm.R, R/PostFC.R, R/GetPatterns.R, R/crit_fun.R).

Model: counts X_gj ~ NB(r_gj, q_gc) with q_gc ~ Beta(alpha, beta_{Ng(g)});
r_gj = r_g * s_j from a method-of-moments fit; the Beta-NB marginal gives a
closed-form predictive density f0. EE/DE (or multi-pattern) mixture weights
and (alpha, beta) hyperparameters are estimated by EM, with the M-step a
Nelder-Mead maximization of the expected complete log-likelihood — the same
scheme as the R package (LogN.R / LogNMulti.R, optim's default method).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.optimize import minimize
from scipy.special import betaln, gammaln

_SHIFT = 600.0  # EBSeq's exp(F + 600) trick (LogN.R:15-18), kept for parity


# --------------------------------------------------------------------- #
# normalization                                                          #
# --------------------------------------------------------------------- #
def median_norm(data: np.ndarray) -> np.ndarray:
    """DESeq median-of-ratios size factors (MedianNorm.R)."""
    data = np.asarray(data, dtype=np.float64)
    if data.shape[1] == 1:
        raise ValueError("Only 1 sample!")
    with np.errstate(divide="ignore"):
        geo = np.exp(np.mean(np.log(data), axis=1))
    ok = geo > 0
    return np.array(
        [np.median(data[ok, j] / geo[ok]) for j in range(data.shape[1])]
    )


def get_normalized_mat(data: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    return np.asarray(data, dtype=np.float64) / np.asarray(sizes)[None, :]


# --------------------------------------------------------------------- #
# Beta-NB predictive density                                             #
# --------------------------------------------------------------------- #
def _lchoose(n: np.ndarray, k: np.ndarray) -> np.ndarray:
    """R lchoose semantics for rounded inputs: -inf outside 0 <= k <= n."""
    with np.errstate(invalid="ignore"):
        v = gammaln(n + 1) - gammaln(k + 1) - gammaln(n - k + 1)
    bad = (k < 0) | (k > n)
    return np.where(bad, -np.inf, v)


def f0_log(X: np.ndarray, alpha: float, beta_rows: np.ndarray,
           Rmat: np.ndarray) -> np.ndarray:
    """log predictive density of rows of X under one shared q ~ Beta
    (f0.R). X, Rmat: [G, n]; beta_rows: [G]."""
    n1 = np.round(X + Rmat - 1)
    k = np.round(X)
    each = _lchoose(n1, k)
    p1 = alpha + Rmat.sum(axis=1)
    p2 = beta_rows + X.sum(axis=1)
    with np.errstate(invalid="ignore"):
        return each.sum(axis=1) + betaln(p1, p2) - betaln(alpha, beta_rows)


# --------------------------------------------------------------------- #
# expression patterns (GetPatterns.R / blockmodeling nkpartitions)       #
# --------------------------------------------------------------------- #
def get_patterns(n_cond: int) -> np.ndarray:
    """All set partitions of n conditions as restricted-growth strings with
    group labels 1..k, ordered by block count then lexicographically —
    matching rbind(nkpartitions(n,1), ..., nkpartitions(n,n))."""
    if n_cond < 3:
        raise ValueError("Less than 3 conditions!")
    all_rgs: List[List[int]] = []

    def rec(prefix: List[int], mx: int):
        if len(prefix) == n_cond:
            all_rgs.append(list(prefix))
            return
        for v in range(1, mx + 2):
            prefix.append(v)
            rec(prefix, max(mx, v))
            prefix.pop()

    rec([1], 1)
    all_rgs.sort(key=lambda a: (max(a), a))
    return np.asarray(all_rgs, dtype=np.int64)


# --------------------------------------------------------------------- #
# shared moment machinery                                                #
# --------------------------------------------------------------------- #
@dataclass
class _Moments:
    order: np.ndarray  # kept-row indices (into nz rows), Ng-grouped order
    X: np.ndarray  # [G, n] ordered counts
    ng_group: np.ndarray  # [G] 0-based Ng group per ordered row
    n_groups: int
    mean_all: np.ndarray  # [G] normalized row means
    mean_sp: List[np.ndarray]  # per condition
    var_min: np.ndarray
    pool_var: np.ndarray
    r: np.ndarray  # empirical r (Inf fixed)
    good: np.ndarray  # bool [G]


def _moments(X: np.ndarray, ng: np.ndarray, cond: np.ndarray,
             sizes: np.ndarray) -> _Moments:
    order = np.argsort(ng, kind="stable")
    X = X[order]
    ngo = ng[order]
    groups = np.unique(ngo)
    gmap = {g: i for i, g in enumerate(groups)}
    ng_group = np.array([gmap[g] for g in ngo])

    dvd = X / sizes[None, :]
    mean_all = dvd.mean(axis=1)
    levels = np.unique(cond)
    mean_sp, var_sp, n_sp = [], [], []
    for lv in levels:
        cols = cond == lv
        s = sizes[cols]
        m = dvd[:, cols].mean(axis=1)
        mean_sp.append(m)
        n_sp.append(int(cols.sum()))
        if cols.sum() > 1:
            pv = ((X[:, cols] - np.outer(m, s)) ** 2 / s[None, :]).sum(axis=1)
            var_sp.append(pv / cols.sum())
        else:
            var_sp.append(None)

    if X.shape[1] == len(levels):  # one sample per condition: Phi pooling
        fc = mean_sp[0] / mean_sp[1] if len(levels) == 2 else None
        if fc is None:
            # multi-condition no-replicate pooling (EBMultiTest.R:153-180)
            mean_pool = dvd.mean(axis=1)
            var_pool = dvd.var(axis=1, ddof=1)
            use = np.ones(len(X), dtype=bool)
        else:
            ok = ~np.isnan(fc)
            lo, hi = np.quantile(fc[ok], [0.25, 0.75])
            use = ok & (fc >= lo) & (fc <= hi)
            var_pool = dvd.var(axis=1, ddof=1)
            mean_pool = (mean_sp[0] + mean_sp[1]) / 2
        v_u, m_u = var_pool[use], mean_pool[use]
        sel = v_u >= m_u
        with np.errstate(invalid="ignore", divide="ignore"):
            phi = np.mean((v_u[sel] - m_u[sel]) / m_u[sel] ** 2)
        var_est = mean_pool * (1 + mean_pool * phi)
        pool_var = var_min = var_est
    else:
        with_rep = [v for v in var_sp if v is not None]
        stacked = np.stack(with_rep, axis=1)
        pool_var = stacked.mean(axis=1)
        var_min = stacked.min(axis=1)

    with np.errstate(divide="ignore", invalid="ignore"):
        get_p = mean_all / pool_var
        r = mean_all * get_p / (1 - get_p)
    finite_max = r[np.isfinite(r)].max(initial=1.0)
    r = np.where(np.isinf(r), finite_max, r)
    good = (r > 0) & (var_min != 0) & ~np.isnan(var_min) & ~np.isnan(r)
    return _Moments(order, X, ng_group, len(groups), mean_all, mean_sp,
                    var_min, pool_var, r, good)


def _poisson_limit_r(mean_rows: np.ndarray, approx: float = 1e-10):
    """R for near-degenerate rows: q -> 1 limit (EBTest.R ApproxVal)."""
    p = 1.0 - approx
    return mean_rows * p / (1 - p)


# --------------------------------------------------------------------- #
# two-condition EBTest                                                   #
# --------------------------------------------------------------------- #
@dataclass
class EBTestResult:
    ppee: np.ndarray  # [G_nz] aligned with `names`
    ppde: np.ndarray
    names: List[str]  # non-all-zero row names, original order
    post_fc: np.ndarray
    real_fc: np.ndarray
    c1_mean: np.ndarray
    c2_mean: np.ndarray
    alpha: float
    beta: np.ndarray  # per Ng group
    p_mix: float
    norm_mat: np.ndarray  # normalized full matrix (incl. zero rows)
    all_zero: np.ndarray  # indices of dropped all-zero rows


def eb_test(
    data: np.ndarray,
    conditions: Sequence[int],
    sizes: Optional[np.ndarray] = None,
    ng_vector: Optional[np.ndarray] = None,
    maxround: int = 5,
    names: Optional[List[str]] = None,
) -> EBTestResult:
    """Two-condition DE test (EBTest.R with default Pool=F path)."""
    data = np.asarray(data, dtype=np.float64)
    cond = np.asarray(conditions)
    if len(np.unique(cond)) != 2:
        raise ValueError("EBTest needs exactly 2 conditions")
    if sizes is None:
        sizes = median_norm(data)
    if names is None:
        names = [f"I{i+1}" for i in range(len(data))]

    nz = data.mean(axis=1) > 0
    all_zero = np.nonzero(~nz)[0]
    X0 = data[nz]
    names_nz = [n for n, keep in zip(names, nz) if keep]
    ng = (np.asarray(ng_vector)[nz] if ng_vector is not None
          else np.ones(len(X0), dtype=np.int64))

    mo = _moments(X0, ng, cond, sizes)
    G = len(X0)
    levels = np.unique(cond)
    cols1, cols2 = cond == levels[0], cond == levels[1]

    beta_of = lambda beta: beta[mo.ng_group]

    Xg = mo.X[mo.good]
    grp_g = mo.ng_group[mo.good]
    r_good = mo.r[mo.good].copy()
    r_good[r_good < 1] += 1  # EBTest.R:246
    Rmat_g = np.outer(r_good, sizes)

    def f01(Xr, Rr, grp, alpha, beta):
        brow = beta[grp]
        F0 = f0_log(Xr, alpha, brow, Rr)
        F1 = (f0_log(Xr[:, cols1], alpha, brow, Rr[:, cols1])
              + f0_log(Xr[:, cols2], alpha, brow, Rr[:, cols2]))
        return F0, F1

    def z_of(F0, F1, p):
        with np.errstate(over="ignore", invalid="ignore"):
            a = p * np.exp(F1 + _SHIFT)
            b = (1 - p) * np.exp(F0 + _SHIFT)
            return a / (a + b)

    alpha, p_mix = 0.5, 0.5
    beta = np.full(mo.n_groups, 0.5)
    z = F0g = F1g = None
    for _ in range(max(1, maxround)):
        F0g, F1g = f01(Xg, Rmat_g, grp_g, alpha, beta)
        z = z_of(F0g, F1g, p_mix)
        zgood = ~np.isnan(z)

        def negloglik(params):
            a = params[0]
            b = params[1 : 1 + mo.n_groups]
            p = params[1 + mo.n_groups]
            if a <= 0 or np.any(b <= 0) or not (0 < p < 1):
                return 1e300
            F0, F1 = f01(Xg[zgood], Rmat_g[zgood], grp_g[zgood], a, b)
            zz = z[zgood]
            val = -(np.sum((1 - zz) * F0) + np.sum(1 - zz) * np.log(1 - p)
                    + np.sum(zz * F1) + np.sum(zz) * np.log(p))
            return val if np.isfinite(val) else 1e300

        res = minimize(
            negloglik,
            np.concatenate([[alpha], beta, [p_mix]]),
            method="Nelder-Mead",
            options={"maxiter": 500, "fatol": 1e-8, "xatol": 1e-8},
        )
        alpha = float(res.x[0])
        beta = np.asarray(res.x[1 : 1 + mo.n_groups])
        p_mix = float(res.x[1 + mo.n_groups])

    # fold NaN-z and NotIn rows back in via the Poisson-limit R
    z_all = np.full(G, np.nan)
    z_all[mo.good] = z
    redo = np.isnan(z_all)
    if redo.any():
        r_na = _poisson_limit_r(mo.mean_all[redo])
        R_na = np.outer(r_na, sizes)
        F0n, F1n = f01(mo.X[redo], R_na, mo.ng_group[redo], alpha, beta)
        z_all[redo] = z_of(F0n, F1n, p_mix)
    z_all[np.isnan(z_all)] = 0.0

    # back to original (pre Ng-sort) row order
    inv = np.empty(G, dtype=np.int64)
    inv[mo.order] = np.arange(G)
    z_out = z_all[inv]
    mean1 = mo.mean_sp[0][inv]
    mean2 = mo.mean_sp[1][inv]
    r_out = mo.r[inv]
    beta_rows_out = beta[mo.ng_group][inv]

    post_fc, real_fc = _post_fc(
        mean1, mean2, r_out, alpha, beta_rows_out,
        int(cols1.sum()), int(cols2.sum()),
    )
    return EBTestResult(
        ppee=1.0 - z_out, ppde=z_out, names=names_nz,
        post_fc=post_fc, real_fc=real_fc, c1_mean=mean1, c2_mean=mean2,
        alpha=alpha, beta=beta, p_mix=p_mix,
        norm_mat=get_normalized_mat(data, sizes), all_zero=all_zero,
    )


def _post_fc(mean1, mean2, r, alpha, beta_rows, n1, n2, small=0.01):
    """Posterior + real fold changes (PostFC.R)."""
    mean_all = (mean1 + mean2) / 2
    real_fc = (mean1 + small) / (mean2 + small)
    r = r.copy()
    bad = (r <= 0) | np.isnan(r)
    r[bad] = mean_all[bad] * 0.99 / 0.01
    pa1 = alpha + n1 * r
    pa2 = alpha + n2 * r
    pb1 = beta_rows + n1 * mean1
    pb2 = beta_rows + n2 * mean2
    q1 = pa1 / (pa1 + pb1)
    q2 = pa2 / (pa2 + pb2)
    post_fc = ((1 - q1) / (1 - q2)) * (q2 / q1)
    return post_fc, real_fc


# --------------------------------------------------------------------- #
# multi-condition EBMultiTest                                            #
# --------------------------------------------------------------------- #
@dataclass
class EBMultiResult:
    pp: np.ndarray  # [G_nz, K] pattern posteriors (NaN rows = NoTest)
    map_pattern: List[str]
    ppde: np.ndarray  # 1 - PP[EE pattern]
    names: List[str]
    patterns: np.ndarray  # [K, C]
    cond_means: np.ndarray  # [G_nz, C] normalized per-condition means
    alpha: float
    beta: np.ndarray
    p_mix: np.ndarray  # [K]
    norm_mat: np.ndarray
    all_zero: np.ndarray


def eb_multi_test(
    data: np.ndarray,
    conditions: Sequence[int],
    sizes: Optional[np.ndarray] = None,
    ng_vector: Optional[np.ndarray] = None,
    patterns: Optional[np.ndarray] = None,
    maxround: int = 5,
    names: Optional[List[str]] = None,
) -> EBMultiResult:
    """Multi-condition DE over all expression patterns (EBMultiTest.R)."""
    data = np.asarray(data, dtype=np.float64)
    cond = np.asarray(conditions)
    levels = np.unique(cond)
    n_cond = len(levels)
    if n_cond < 3 and patterns is None:
        raise ValueError("Use eb_test for 2 conditions")
    if patterns is None:
        patterns = get_patterns(n_cond)
    K = len(patterns)
    if sizes is None:
        sizes = median_norm(data)
    if names is None:
        names = [f"I{i+1}" for i in range(len(data))]

    nz = data.mean(axis=1) > 0
    all_zero = np.nonzero(~nz)[0]
    X0 = data[nz]
    names_nz = [n for n, keep in zip(names, nz) if keep]
    ng = (np.asarray(ng_vector)[nz] if ng_vector is not None
          else np.ones(len(X0), dtype=np.int64))

    mo = _moments(X0, ng, cond, sizes)
    G = len(X0)
    cond_cols = [cond == lv for lv in levels]

    Xg = mo.X[mo.good]
    grp_g = mo.ng_group[mo.good]
    r_good = mo.r[mo.good].copy()
    r_good[r_good < 1] += 1
    Rmat_g = np.outer(r_good, sizes)

    def f_patterns(Xr, Rr, grp, alpha, beta) -> np.ndarray:
        """[Grows, K] log density under each pattern (LogNMulti.R:7-12)."""
        brow = beta[grp]
        out = np.empty((len(Xr), K))
        for pi, parti in enumerate(patterns):
            tot = np.zeros(len(Xr))
            for g in np.unique(parti):
                cols = np.zeros(len(cond), dtype=bool)
                for ci, lv_in_g in enumerate(parti):
                    if lv_in_g == g:
                        cols |= cond_cols[ci]
                tot += f0_log(Xr[:, cols], alpha, brow, Rr[:, cols])
            out[:, pi] = tot
        return out

    alpha = 0.5
    beta = np.full(mo.n_groups, 0.5)
    p_mix = np.full(K, 1.0 / K)
    z = None
    for _ in range(max(1, maxround)):
        F = f_patterns(Xg, Rmat_g, grp_g, alpha, beta)
        with np.errstate(over="ignore", invalid="ignore"):
            Fm = np.exp(F + _SHIFT) * p_mix[None, :]
            denom = Fm.sum(axis=1)
            z = Fm / denom[:, None]
            lf = z * np.log(Fm)
        bad = np.isnan(denom) | np.isnan(lf.sum(axis=1))
        zgood = ~bad

        def negloglik(params):
            a = params[0]
            b = params[1 : 1 + mo.n_groups]
            pk = params[1 + mo.n_groups :]
            p_all = np.concatenate([[1.0 - pk.sum()], pk])
            if a <= 0 or np.any(b <= 0) or np.any(p_all <= 0):
                return 1e300
            Fz = f_patterns(Xg[zgood], Rmat_g[zgood], grp_g[zgood], a, b)
            val = -np.sum(z[zgood] * (Fz + np.log(p_all)[None, :]))
            return val if np.isfinite(val) else 1e300

        res = minimize(
            negloglik,
            np.concatenate([[alpha], beta, p_mix[1:]]),
            method="Nelder-Mead",
            options={"maxiter": 500, "fatol": 1e-8, "xatol": 1e-8},
        )
        alpha = float(res.x[0])
        beta = np.asarray(res.x[1 : 1 + mo.n_groups])
        pk = np.asarray(res.x[1 + mo.n_groups :])
        p_mix = np.concatenate([[1.0 - pk.sum()], pk])

    # all rows (good + NaN + NotIn): final posteriors
    pp_all = np.full((G, K), np.nan)
    pp_all[mo.good] = z
    redo = np.isnan(pp_all.sum(axis=1))
    if redo.any():
        r_na = _poisson_limit_r(mo.mean_all[redo])
        R_na = np.outer(r_na, sizes)
        Fn = f_patterns(mo.X[redo], R_na, mo.ng_group[redo], alpha, beta)
        with np.errstate(over="ignore", invalid="ignore"):
            Fm = np.exp(Fn + _SHIFT) * p_mix[None, :]
            pp_all[redo] = Fm / Fm.sum(axis=1)[:, None]

    inv = np.empty(G, dtype=np.int64)
    inv[mo.order] = np.arange(G)
    pp = pp_all[inv]

    ee_idx = int(np.nonzero((patterns == 1).all(axis=1))[0][0])
    map_pattern = []
    for row in pp:
        if np.isnan(row).any():
            map_pattern.append("NoTest")
        else:
            map_pattern.append(f"Pattern{int(np.argmax(row)) + 1}")
    with np.errstate(invalid="ignore"):
        ppde = 1.0 - pp[:, ee_idx]

    cond_means = np.stack([m[inv] for m in mo.mean_sp], axis=1)
    return EBMultiResult(
        pp=pp, map_pattern=map_pattern, ppde=ppde, names=names_nz,
        patterns=patterns, cond_means=cond_means, alpha=alpha, beta=beta,
        p_mix=p_mix, norm_mat=get_normalized_mat(data, sizes),
        all_zero=all_zero,
    )


def crit_fun(ppee: np.ndarray, threshold: float) -> float:
    """Soft FDR threshold on PPDE (crit_fun.R)."""
    y = np.cumsum(np.sort(ppee)) / np.arange(1, len(ppee) + 1)
    index = int((y < threshold).sum())
    if index > 0:
        return float(1 - np.sort(ppee)[index - 1])
    return 1.0
