"""Ng vector for EBSeq isoform analysis: k-mer unmappability + 3-means.

Behavioral parity with the reference pipeline (rsem-generate-ngvector =
EBSeq/calcClusteringInfo.cpp + kmeans in
rsem-for-ebseq-generate-ngvector-from-clustering-info):

  - unmappability(t) = (# k-mers of t that also occur elsewhere — another
    transcript, or another position when shared) / (# k-mers of t); exactly:
    for every distinct k-mer string, each transcript contributes its
    occurrence count unless it owns ALL occurrences
    (calcClusteringInfo.cpp:113-130). Transcripts shorter than k get -1.
  - cluster the >= 0 scores into 3 groups with k-means; clusters are
    relabeled 1..3 in ascending order of center; score<0 rows get group 3.

The k-mer sweep is vectorized: all windows are materialized as fixed-width
byte rows and sorted with one np.argsort (void view), replacing the
reference's comparator sort over (tid, pos) candidates.
"""

from __future__ import annotations

from typing import List, TextIO, Tuple

import numpy as np

from ..refprep.fasta import read_fasta


def _clean(seq: str) -> bytes:
    up = seq.upper().encode("latin-1")
    arr = np.frombuffer(up, dtype=np.uint8).copy()
    valid = ((arr == ord("A")) | (arr == ord("C")) | (arr == ord("G"))
             | (arr == ord("T")))
    arr[~valid] = ord("N")
    return arr.tobytes()


def unmappability(names: List[str], seqs: List[str], k: int = 25
                  ) -> np.ndarray:
    """Scores in transcript order; -1 for transcripts with no k-mer."""
    M = len(seqs)
    rows = []
    tids = []
    eff = np.zeros(M, dtype=np.int64)
    for t, s in enumerate(seqs):
        b = _clean(s)
        n = len(b) - k + 1
        if n <= 0:
            continue
        eff[t] = n
        win = np.lib.stride_tricks.sliding_window_view(
            np.frombuffer(b, dtype=np.uint8), k
        )
        rows.append(win)
        tids.append(np.full(n, t, dtype=np.int64))
    scores = np.full(M, -1.0)
    if not rows:
        return scores

    kmers = np.ascontiguousarray(np.concatenate(rows, axis=0))
    tid = np.concatenate(tids)
    voids = kmers.view([("v", f"V{k}")]).ravel()
    order = np.argsort(voids, kind="stable")
    sv = voids[order]
    st = tid[order]

    # run boundaries over identical k-mers
    new_run = np.empty(len(sv), dtype=bool)
    new_run[0] = True
    new_run[1:] = sv[1:] != sv[:-1]
    run_id = np.cumsum(new_run) - 1
    run_sizes = np.bincount(run_id)

    # within each run, count occurrences per (run, tid) segment
    seg_start = new_run | np.concatenate([[True], st[1:] != st[:-1]])
    seg_id = np.cumsum(seg_start) - 1
    seg_sizes = np.bincount(seg_id)
    seg_tid = st[seg_start]
    seg_run = run_id[seg_start]

    counted = seg_sizes < run_sizes[seg_run]  # numerator < denominator
    contrib = np.where(counted, seg_sizes, 0)
    acc = np.bincount(seg_tid, weights=contrib, minlength=M)

    has = eff > 0
    scores[has] = acc[has] / eff[has]
    return scores


def kmeans_1d(values: np.ndarray, k: int = 3, iters: int = 100
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm on scalars with quantile-spread init (deterministic
    stand-in for R's kmeans random start; clusters are relabeled by the
    caller so only the converged partition matters)."""
    vals = np.asarray(values, dtype=np.float64)
    uniq = np.unique(vals)
    if len(uniq) <= k:
        centers = uniq
        assign = np.searchsorted(uniq, vals)
        return assign, centers
    centers = np.quantile(vals, np.linspace(0, 1, 2 * k + 1)[1::2])
    for _ in range(iters):
        d = np.abs(vals[:, None] - centers[None, :])
        assign = d.argmin(axis=1)
        new_centers = np.array([
            vals[assign == c].mean() if (assign == c).any() else centers[c]
            for c in range(k)
        ])
        if np.allclose(new_centers, centers):
            break
        centers = new_centers
    return assign, centers


def ng_vector_from_scores(scores: np.ndarray) -> np.ndarray:
    """Cluster scores into Ng groups 1..3 (ascending unmappability);
    score<0 -> 3 (rsem-for-ebseq-generate-ngvector-from-clustering-info)."""
    ng = np.full(len(scores), 3, dtype=np.int64)
    idx = scores >= 0
    if idx.sum() == 0:
        return ng
    assign, centers = kmeans_1d(scores[idx], k=min(3, max(1, idx.sum())))
    rank = np.argsort(np.argsort(centers)) + 1  # ascending centers -> 1..k
    ng[idx] = rank[assign]
    return ng


def generate_ngvector(fasta_path: str, output_name: str, k: int = 25,
                      quiet: bool = False) -> np.ndarray:
    names: List[str] = []
    seqs: List[str] = []
    for tag, seq in read_fasta(fasta_path):
        if not seq:
            if not quiet:
                print(f"Warning: Fasta entry {tag} has an empty sequence! "
                      "It is omitted!")
            continue
        names.append(tag.split()[0])
        seqs.append(seq)
    scores = unmappability(names, seqs, k=k)
    with open(f"{output_name}.ump", "w") as f:
        for n, s in zip(names, scores):
            f.write(f"{n}\t{s:.6g}\n")
    ng = ng_vector_from_scores(scores)
    with open(f"{output_name}.ngvec", "w") as f:
        for v in ng:
            f.write(f"{v}\n")
    return ng
