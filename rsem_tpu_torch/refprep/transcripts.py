"""Transcript metadata structures and their on-disk formats.

File formats are byte-compatible with the reference so its downstream tools
(plotting scripts, EBSeq, IGV workflows) keep working:
  .ti  transcript info (reference: Transcript.h:150-167, Transcripts.h:96-103)
  .grp gene->isoform start array (reference: extractRef.cpp:266-269)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass
class Transcript:
    transcript_id: str
    gene_id: str
    seqname: str  # chromosome, or allele name in transcript-set mode
    strand: str  # '+' or '-'
    structure: List[Tuple[int, int]]  # 1-based inclusive exon intervals
    left: str = ""  # leftover GTF attributes
    transcript_name: str = ""
    gene_name: str = ""

    def __post_init__(self):
        self.left = self.left.lstrip(" ")

    @property
    def length(self) -> int:
        return sum(e - s + 1 for s, e in self.structure)

    def sort_key(self):
        # reference: Transcript.h operator< (gene_id, transcript_id, seqname)
        return (self.gene_id, self.transcript_id, self.seqname)

    def extract_seq(self, genome: str) -> str:
        """Splice exons out of `genome`; reverse-complement on '-' strand
        (reference: Transcript.h:90-117)."""
        from ..utils.seq import revcomp

        if self.structure[0][0] < 1 or self.structure[-1][1] > len(genome):
            raise ValueError(
                f"Transcript {self.transcript_id} is out of chromosome "
                f"{self.seqname}'s boundary!"
            )
        seq = "".join(genome[s - 1 : e] for s, e in self.structure)
        if self.strand == "-":
            seq = revcomp(seq)
        elif self.strand != "+":
            raise ValueError(f"Bad strand {self.strand!r}")
        assert len(seq) > 0
        return seq


@dataclass
class Transcripts:
    """1-indexed transcript collection; index 0 is the noise isoform.

    type: 0 from genome, 1 standalone transcript set, 2 allele-specific
    (reference: Transcripts.h:20-38).
    """

    type: int = 0
    transcripts: List[Transcript] = field(default_factory=list)

    @property
    def M(self) -> int:
        return len(self.transcripts)

    def get(self, sid: int) -> Transcript:
        assert 1 <= sid <= self.M
        return self.transcripts[sid - 1]

    def add(self, tr: Transcript):
        self.transcripts.append(tr)

    def sort(self):
        self.transcripts.sort(key=Transcript.sort_key)

    @property
    def is_allele_specific(self) -> bool:
        return self.type == 2

    def lengths(self) -> np.ndarray:
        """Transcript lengths, index 0 unused (= 0)."""
        return np.array([0] + [t.length for t in self.transcripts], dtype=np.int64)

    # --- .ti serialization -------------------------------------------------
    def write_ti(self, path: str):
        with open(path, "w") as f:
            f.write(f"{self.M} {self.type}\n")
            for t in self.transcripts:
                f.write(t.transcript_id)
                if t.transcript_name:
                    f.write("\t" + t.transcript_name)
                f.write("\n")
                f.write(t.gene_id)
                if t.gene_name:
                    f.write("\t" + t.gene_name)
                f.write("\n")
                f.write(t.seqname + "\n")
                f.write(f"{t.strand} {t.length}\n")
                f.write(str(len(t.structure)))
                for s, e in t.structure:
                    f.write(f" {s} {e}")
                f.write("\n")
                f.write(t.left + "\n")

    @classmethod
    def read_ti(cls, path: str) -> "Transcripts":
        with open(path) as f:
            first = f.readline().split()
            M, type_ = int(first[0]), int(first[1])
            out = cls(type=type_)
            for _ in range(M):
                tid_line = f.readline().rstrip("\n").split("\t")
                gid_line = f.readline().rstrip("\n").split("\t")
                seqname = f.readline().rstrip("\n")
                strand_len = f.readline().split()
                struct_line = f.readline().split()
                left = f.readline().rstrip("\n")
                n_exons = int(struct_line[0])
                structure = [
                    (int(struct_line[1 + 2 * i]), int(struct_line[2 + 2 * i]))
                    for i in range(n_exons)
                ]
                tr = Transcript(
                    transcript_id=tid_line[0],
                    gene_id=gid_line[0],
                    seqname=seqname,
                    strand=strand_len[0],
                    structure=structure,
                    left=left,
                    transcript_name=tid_line[1] if len(tid_line) > 1 else "",
                    gene_name=gid_line[1] if len(gid_line) > 1 else "",
                )
                assert tr.length == int(strand_len[1]), (
                    f"{tr.transcript_id}: stored length {strand_len[1]} != "
                    f"structure length {tr.length}"
                )
                out.add(tr)
        return out

    # --- group arrays ------------------------------------------------------
    def gene_group_starts(self) -> List[int]:
        """m+1 start sids for .grp; transcripts must be sorted by gene."""
        starts: List[int] = []
        cur = None
        for i, t in enumerate(self.transcripts, start=1):
            if t.gene_id != cur:
                starts.append(i)
                cur = t.gene_id
        starts.append(self.M + 1)
        return starts


class GroupInfo:
    """Prefix-start grouping (gene->isoform .grp, gene->transcript .gt,
    transcript->allele .ta; reference: GroupInfo.h:8-53)."""

    def __init__(self, starts):
        self.starts = np.asarray(starts, dtype=np.int64)
        assert len(self.starts) >= 2
        # map member index -> group id
        n_members = int(self.starts[-1]) - int(self.starts[0])
        self._base = int(self.starts[0])
        gids = np.zeros(n_members, dtype=np.int64)
        for g in range(self.m):
            gids[self.starts[g] - self._base : self.starts[g + 1] - self._base] = g
        self._gids = gids

    @property
    def m(self) -> int:
        return len(self.starts) - 1

    def span(self, gid: int) -> Tuple[int, int]:
        return int(self.starts[gid]), int(self.starts[gid + 1])

    def gid_at(self, member: int) -> int:
        return int(self._gids[member - self._base])

    def gids_of(self, members: np.ndarray) -> np.ndarray:
        return self._gids[np.asarray(members, dtype=np.int64) - self._base]

    def write(self, path: str):
        with open(path, "w") as f:
            for s in self.starts:
                f.write(f"{int(s)}\n")

    @classmethod
    def load(cls, path: str) -> "GroupInfo":
        with open(path) as f:
            starts = [int(line) for line in f if line.strip()]
        return cls(starts)
