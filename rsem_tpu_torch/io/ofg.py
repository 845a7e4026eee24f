"""`.ofg` / `.countvectors` interop artifacts.

These are the reference's stage-restart surface between EM, Gibbs and CI:
`.ofg` holds the final-model conditional probabilities as a sparse
per-read list (written EM.cpp:435-457, read Gibbs.cpp:111-131; noise slot
= sid 0, probabilities below EPSILON dropped, reads with no surviving
entry dropped); `.countvectors` holds one retained Gibbs count vector of
M+1 ints per line (Gibbs.cpp:255-262, read calcCI.cpp:112-113).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..constants import EPSILON


def write_ofg(path: str, M: int, N0: int, hits, log_conprb: np.ndarray,
              log_ncp: np.ndarray) -> None:
    """hits: io.HitArrays; log_conprb/log_ncp: final-model log conditional
    probabilities ([n_hits]/[n_reads], natural log, -inf for zeros)."""
    conprb = np.exp(np.asarray(log_conprb, dtype=np.float64))
    ncp = np.exp(np.asarray(log_ncp, dtype=np.float64))
    offs = hits.read_offsets
    sid = hits.sid
    with open(path, "w") as f:
        f.write(f"{M} {N0}\n")
        for i in range(hits.n_reads):
            parts = []
            if ncp[i] >= EPSILON:
                parts.append(f"0 {ncp[i]:.15g} ")
            for k in range(int(offs[i]), int(offs[i + 1])):
                if conprb[k] >= EPSILON:
                    parts.append(f"{int(sid[k])} {conprb[k]:.15g} ")
            if parts:
                f.write("".join(parts) + "\n")


def load_ofg(path: str) -> Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (M, N0, read_offsets [N+1], sid [H], conprb [H]) — the CSR
    the Gibbs sampler consumes (noise entries carry sid 0)."""
    with open(path) as f:
        first = f.readline().split()
        M, N0 = int(first[0]), int(first[1])
        offsets = [0]
        sids: list = []
        cps: list = []
        for line in f:
            tok = line.split()
            for j in range(0, len(tok) - 1, 2):
                sids.append(int(tok[j]))
                cps.append(float(tok[j + 1]))
            offsets.append(len(sids))
    return (M, N0, np.asarray(offsets, dtype=np.int64),
            np.asarray(sids, dtype=np.int32), np.asarray(cps))


def gibbs_inputs_from_ofg(path: str):
    """Rebuild engine.gibbs.run_gibbs inputs from a `.ofg` file (stage
    restart: rerun the sampler without redoing parse+EM, the reference's
    rsem-run-gibbs entry). Returns (M, N0, hits_view, log_conprb, log_ncp)
    where hits_view exposes .sid/.read_offsets/.n_reads/.n_hits."""
    from types import SimpleNamespace

    M, N0, offs, sid, cp = load_ofg(path)
    N = len(offs) - 1
    is_noise = sid == 0
    with np.errstate(divide="ignore"):
        log_ncp = np.full(N, -np.inf)
        rid = np.repeat(np.arange(N), np.diff(offs))
        log_ncp[rid[is_noise]] = np.log(cp[is_noise])
        keep = ~is_noise
        log_conprb = np.log(cp[keep])
    new_nh = np.bincount(rid[keep], minlength=N)
    new_offs = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(new_nh, out=new_offs[1:])
    hits_view = SimpleNamespace(
        sid=sid[keep].astype(np.int32),
        read_offsets=new_offs,
        n_reads=N,
        n_hits=int(new_offs[-1]),
    )
    return M, N0, hits_view, log_conprb, log_ncp


def write_countvectors(path: str, countvectors: np.ndarray) -> None:
    """[S, M+1] retained Gibbs count vectors -> reference text format."""
    cvs = np.asarray(np.rint(countvectors), dtype=np.int64)
    with open(path, "w") as f:
        for row in cvs:
            f.write(" ".join(str(int(x)) for x in row) + "\n")


def load_countvectors(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64, ndmin=2)
