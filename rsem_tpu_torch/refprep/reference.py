"""The Reference bundle: canonicalized transcript sequences + poly(A) masks.

This is the TPU-side replacement for the reference's Refs/RefSeq pair
(reference: Refs.h, RefSeq.h): sequences are stored as one concatenated uint8
base-code array with per-transcript offsets, ready to be gathered by the
likelihood kernels; masks exploit the fact that RSEM only ever masks the
contiguous window [max(fullLen-OLEN+1,0), fullLen) when a poly(A) tail is
appended (reference: RefSeq.h:33-37).

Serialization is byte-compatible with RSEM's .seq / .idx.fa / .n2g.idx.fa
formats (reference: RefSeq.h:110-138, preRef.cpp:64-87).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Set

import numpy as np

from ..constants import NBITS, OLEN, DEFAULT_POLYA_LEN
from ..utils.seq import canonicalize_transcript, decode, encode, n_to_g
from .fasta import read_fasta


@dataclass
class PolyARules:
    """Poly(A)-padding policy (reference: PolyARules.h:15-59).

    choice 0: pad all; 1: pad none; 2: pad all except `exceptions`.
    """

    choice: int = 1
    polya_len: int = DEFAULT_POLYA_LEN
    exceptions: Optional[Set[str]] = None

    def len_at(self, transcript_id: str) -> int:
        if self.choice == 0:
            return self.polya_len
        if self.choice == 1:
            return 0
        if self.choice == 2:
            assert self.exceptions is not None
            return 0 if transcript_id in self.exceptions else self.polya_len
        raise ValueError(f"Bad polyA choice {self.choice}")


class Reference:
    """M transcripts (1-indexed; 0 is the noise isoform).

    Attributes (all numpy, shape [M+1]; index 0 is a zero-length placeholder):
      full_len   original transcript lengths
      tot_len    lengths including appended poly(A) tails
      offsets    start of each transcript in `codes` ([M+2] prefix array)
      mask_start first masked forward-strand seed position, or full_len when
                 the transcript has no masked positions
      names      transcript names (python list, [M+1], names[0] = "")
      codes      concatenated uint8 base codes (A0 C1 G2 T3 N4), poly(A)
                 included

    Immutable once built: the layout's device cache (ops/layout.py) keeps
    the device copy of these arrays for as long as the object lives and
    rebuilds it only when an attribute is replaced or a sampled element
    changes; an in-place edit of an unsampled element is not detected.
    """

    def __init__(self, names: List[str], seqs: List[str], polya_lens: List[int]):
        M = len(names)
        assert len(seqs) == M and len(polya_lens) == M
        self.names = [""] + list(names)
        full = np.zeros(M + 1, dtype=np.int64)
        tot = np.zeros(M + 1, dtype=np.int64)
        chunks = [np.zeros(0, dtype=np.uint8)]
        mask_start = np.zeros(M + 1, dtype=np.int64)
        for i, (seq, pl) in enumerate(zip(seqs, polya_lens), start=1):
            fl = len(seq)
            assert fl > 0, f"Transcript {names[i-1]} has an empty sequence!"
            full[i] = fl
            tot[i] = fl + pl
            padded = seq + "A" * pl
            chunks.append(encode(padded).astype(np.uint8))
            # Masked window is [max(fl-OLEN+1,0), fl) iff a tail was added
            # (reference: RefSeq.h:33-37).
            mask_start[i] = max(fl - OLEN + 1, 0) if pl > 0 else fl
        self.full_len = full
        self.tot_len = tot
        self.mask_start = mask_start
        self.codes = np.concatenate(chunks)
        self.offsets = np.zeros(M + 2, dtype=np.int64)
        np.cumsum(tot, out=self.offsets[1 : M + 2])

    @property
    def M(self) -> int:
        return len(self.names) - 1

    @property
    def has_polya(self) -> bool:
        return bool((self.tot_len > self.full_len).any())

    def seq_codes(self, sid: int) -> np.ndarray:
        return self.codes[self.offsets[sid] : self.offsets[sid + 1]]

    def seq_str(self, sid: int) -> str:
        return decode(self.seq_codes(sid))

    def get_mask(self, sid: int, seed_pos) -> np.ndarray:
        """True where the forward-strand seed position is masked."""
        sp = np.asarray(seed_pos)
        return (sp >= self.mask_start[sid]) & (sp < self.full_len[sid])

    # --- construction ------------------------------------------------------
    @classmethod
    def from_fasta(cls, fasta_path: str, rules: PolyARules) -> "Reference":
        """rsem-preref equivalent (reference: preRef.cpp, Refs::makeRefs)."""
        names, seqs, plens = [], [], []
        for tag, raw in read_fasta(fasta_path):
            if not raw:
                continue  # omitted with a warning in the reference
            names.append(tag)
            seqs.append(canonicalize_transcript(raw))
            plens.append(rules.len_at(tag))
        return cls(names, seqs, plens)

    # --- serialization -----------------------------------------------------
    def save_seq(self, path: str):
        """Write RSEM-compatible .seq (reference: RefSeq.h:130-138)."""
        with open(path, "w") as f:
            for i in range(1, self.M + 1):
                fl, tl = int(self.full_len[i]), int(self.tot_len[i])
                f.write(f"{fl} {tl}\n{self.names[i]}\n{self.seq_str(i)}\n")
                nwords = (fl - 1) // NBITS + 1
                words = np.zeros(nwords, dtype=np.uint64)
                ms = int(self.mask_start[i])
                for pos in range(ms, fl):
                    words[pos // NBITS] |= np.uint64(1 << (pos % NBITS))
                f.write(" ".join(str(int(w)) for w in words) + "\n")

    @classmethod
    def load_seq(cls, path: str) -> "Reference":
        """Load an RSEM .seq file (also accepts files written by RSEM itself).

        Masks must form a contiguous tail window ending at fullLen; RSEM only
        ever produces such masks (poly(A) junction window).
        """
        names, seqs, plens, mask_starts = [], [], [], []
        with open(path) as f:
            while True:
                header = f.readline()
                if not header.strip():
                    break
                fl, tl = (int(x) for x in header.split())
                name = f.readline().rstrip("\n")
                seq = f.readline().rstrip("\n")
                nwords = (fl - 1) // NBITS + 1
                words = []
                while len(words) < nwords:
                    words.extend(int(x) for x in f.readline().split())
                words_arr = np.array(words, dtype=np.uint32)
                bits = np.unpackbits(words_arr.view(np.uint8), bitorder="little")[:fl]
                masked = np.flatnonzero(bits)
                if masked.size == 0:
                    ms = fl
                else:
                    ms = int(masked[0])
                    assert (
                        masked.size == fl - ms
                    ), f"{name}: non-contiguous fmask not supported"
                assert len(seq) == tl
                names.append(name)
                # constructor re-appends the poly(A) tail itself
                seqs.append(seq[:fl])
                plens.append(tl - fl)
                mask_starts.append(ms)
        ref = cls(names, seqs, plens)
        ref.mask_start[1:] = np.array(mask_starts, dtype=np.int64)
        return ref

    def save_idx_fasta(self, path: str, n2g: bool = False):
        """.idx.fa / .n2g.idx.fa for aligner index builds (preRef.cpp:73-87)."""
        with open(path, "w") as f:
            for i in range(1, self.M + 1):
                seq = self.seq_str(i)
                if n2g:
                    seq = n_to_g(seq)
                f.write(f">{self.names[i]}\n{seq}\n")


def load_polya_exceptions(path: str) -> Set[str]:
    with open(path) as f:
        return set(f.read().split())
