"""Hit (alignment) storage: flat structure-of-arrays CSR over reads.

Replaces the reference's HitContainer/.dat pipeline (HitContainer.h,
parseIt.cpp) with device-ready arrays; `.dat` and `.cnt` serialization is kept
for interop/checkpointing (formats: parseIt.cpp:195-223,
cnt_file_description.txt).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, TextIO, Tuple

import numpy as np


@dataclass
class HitArrays:
    """All alignments of the N1 alignable reads, grouped by read.

    rid[h] is non-decreasing; read_offsets is the CSR row index ([N1+1]).
    sid >= 1 (0 is the noise isoform and never appears here); dir 0 forward /
    1 reverse; pos is 0-based strand-local (reference: SamParser.h coordinate
    flip); insert_len only for paired data (fragment length), else None.

    Immutable once built: the layout's device cache (ops/layout.py) keeps
    the device copy of these arrays for as long as the object lives and
    rebuilds it only when an attribute is replaced or a sampled element
    changes; an in-place edit of an unsampled element is not detected.
    """

    rid: np.ndarray
    sid: np.ndarray
    dir: np.ndarray
    pos: np.ndarray
    insert_len: Optional[np.ndarray]
    read_offsets: np.ndarray

    @property
    def n_hits(self) -> int:
        return len(self.sid)

    @property
    def n_reads(self) -> int:
        return len(self.read_offsets) - 1

    @property
    def paired(self) -> bool:
        return self.insert_len is not None

    @classmethod
    def from_lists(cls, per_read_hits, paired: bool) -> "HitArrays":
        """per_read_hits: list over reads of lists of
        (signed_sid, pos[, insertL]); sign encodes strand like the reference
        (SingleHit.h:8)."""
        counts = np.array([len(h) for h in per_read_hits], dtype=np.int64)
        offsets = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        H = int(offsets[-1])
        rid = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
        sid = np.zeros(H, dtype=np.int32)
        direc = np.zeros(H, dtype=np.int8)
        pos = np.zeros(H, dtype=np.int32)
        ins = np.zeros(H, dtype=np.int32) if paired else None
        k = 0
        for hits in per_read_hits:
            for t in hits:
                ssid = t[0]
                sid[k] = abs(ssid)
                direc[k] = 1 if ssid < 0 else 0
                pos[k] = t[1]
                if paired:
                    ins[k] = t[2]
                k += 1
        return cls(rid, sid, direc, pos, ins, offsets)

    def hits_per_read(self) -> np.ndarray:
        return np.diff(self.read_offsets)

    # --- statistics (reference: HitContainer.h:96-116) ---------------------
    def _n_multi_key_reads(self, key: np.ndarray) -> int:
        """# reads whose hits span >1 distinct value of key[h] (vectorized:
        sort hits by (read, key), count per-read distinct runs)."""
        n = self.n_reads
        if n == 0 or self.n_hits == 0:
            return 0
        order = np.lexsort((key, self.rid))
        rid_s = self.rid[order]
        key_s = key[order]
        new_run = np.empty(len(order), dtype=bool)
        new_run[0] = True
        new_run[1:] = (rid_s[1:] != rid_s[:-1]) | (key_s[1:] != key_s[:-1])
        distinct = np.bincount(rid_s, weights=new_run, minlength=n)
        return int((distinct > 1).sum())

    def n_gene_multi_reads(self, sid2gid: np.ndarray) -> int:
        """# reads whose hits span >1 gene."""
        return self._n_multi_key_reads(sid2gid[self.sid])

    def n_isoform_multi_reads(self) -> int:
        """# reads with >1 distinct isoform among hits."""
        return self._n_multi_key_reads(self.sid)

    # --- .dat interop ------------------------------------------------------
    def write_dat(self, path: str, read_type: int):
        """reference format: `N1 nHits read_type` then per read
        `cnt sid pos [insertL] ...` with sid sign encoding strand
        (parseIt.cpp:195-211, HitContainer.h:81-91)."""
        signed = np.where(self.dir == 1, -self.sid, self.sid)
        with open(path, "w") as f:
            header = f"{self.n_reads} {self.n_hits} {read_type}"
            f.write(header + " " * (99 - len(header)) + "\n")
            for s, e in zip(self.read_offsets[:-1], self.read_offsets[1:]):
                parts = [str(e - s)]
                for h in range(s, e):
                    parts.append(f" {signed[h]} {self.pos[h]}")
                    if self.paired:
                        parts.append(f" {self.insert_len[h]}")
                f.write("".join(parts) + "\n")

    @classmethod
    def read_dat(cls, path: str) -> Tuple["HitArrays", int]:
        with open(path) as f:
            n1, n_hits, read_type = (int(x) for x in f.readline().split())
            paired = read_type >= 2
            per_read = []
            for _ in range(n1):
                toks = f.readline().split()
                cnt = int(toks[0])
                step = 3 if paired else 2
                hits = []
                for k in range(cnt):
                    base = 1 + k * step
                    hits.append(tuple(int(x) for x in toks[base : base + step]))
                per_read.append(hits)
        out = cls.from_lists(per_read, paired)
        assert out.n_hits == n_hits
        return out, read_type


@dataclass
class CntStats:
    """Alignment statistics (.cnt; spec: cnt_file_description.txt)."""

    N0: int = 0
    N1: int = 0
    N2: int = 0
    n_unique: int = 0
    n_multi: int = 0
    n_iso_multi: int = 0
    n_hits: int = 0
    read_type: int = 0
    hist: Optional[Dict[int, int]] = None  # alignments/read -> #reads

    @property
    def n_tot(self) -> int:
        return self.N0 + self.N1 + self.N2

    def write(self, path: str):
        with open(path, "w") as f:
            f.write(f"{self.N0} {self.N1} {self.N2} {self.n_tot}\n")
            f.write(f"{self.n_unique} {self.n_multi} {self.n_iso_multi}\n")
            f.write(f"{self.n_hits} {self.read_type}\n")
            f.write(f"0\t{self.N0}\n")
            for k in sorted(self.hist or {}):
                f.write(f"{k}\t{self.hist[k]}\n")
            f.write(f"Inf\t{self.N2}\n")

    @classmethod
    def load(cls, path: str) -> "CntStats":
        with open(path) as f:
            N0, N1, N2, _ = (int(x) for x in f.readline().split())
            nu, nm, nim = (int(x) for x in f.readline().split())
            nh, rt = (int(x) for x in f.readline().split())
            hist = {}
            for line in f:
                parts = line.split()
                if len(parts) != 2 or parts[0] in ("0", "Inf"):
                    continue
                hist[int(parts[0])] = int(parts[1])
        return cls(N0, N1, N2, nu, nm, nim, nh, rt, hist)
