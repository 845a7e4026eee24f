"""Vectorized nucleotide-sequence encoding utilities.

Base codes follow the reference convention (reference: utils.h:36-75):
A=0 C=1 G=2 T=3 N=4 (case-insensitive); the reverse-complement code table
maps A->3 C->2 G->1 T->0 N->4.
"""

from __future__ import annotations

import numpy as np

# Lookup tables over the full byte range; invalid characters map to -1 so
# callers can detect them cheaply after a vectorized pass.
_BASE2ID = np.full(256, -1, dtype=np.int8)
_RBASE2ID = np.full(256, -1, dtype=np.int8)
for _c, _i in zip(b"ACGTN", range(5)):
    _BASE2ID[_c] = _i
    _BASE2ID[_c + 32] = _i  # lowercase
for _c, _i in zip(b"ACGTN", [3, 2, 1, 0, 4]):
    _RBASE2ID[_c] = _i
    _RBASE2ID[_c + 32] = _i

_ID2CHAR = np.frombuffer(b"ACGTN", dtype=np.uint8)

# Canonicalization used for reference transcripts (RefSeqPolicy.h): uppercase;
# anything not ACGT becomes N.
_CANON = np.full(256, ord("N"), dtype=np.uint8)
for _c in b"ACGT":
    _CANON[_c] = _c
    _CANON[_c + 32] = _c

# Genome FASTA canonicalization (extractRef.cpp check()): preserve case,
# non-ACGT letters become N/n matching case; non-alpha is an error.
_GCANON = np.full(256, 0, dtype=np.uint8)
for _b in range(256):
    c = chr(_b)
    if c.isalpha():
        if c.isupper():
            _GCANON[_b] = _b if c in "ACGT" else ord("N")
        else:
            _GCANON[_b] = _b if c in "acgt" else ord("n")

_COMPLEMENT = np.zeros(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTNacgtn", b"TGCANtgcan"):
    _COMPLEMENT[_a] = _b


def to_bytes(seq) -> np.ndarray:
    """str/bytes -> uint8 array."""
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    return np.frombuffer(seq, dtype=np.uint8)


def encode(seq, table: np.ndarray = _BASE2ID) -> np.ndarray:
    """Sequence -> int8 base codes. Raises on characters outside acgtnACGTN."""
    b = to_bytes(seq)
    ids = table[b]
    if ids.min(initial=0) < 0:
        bad = b[ids < 0][0]
        raise ValueError(f"Unknown sequence letter {chr(bad)!r}")
    return ids


def encode_rc_codes(seq) -> np.ndarray:
    """Base codes of the reverse complement, reading 3'->5' of `seq` reversed."""
    return encode(seq, _RBASE2ID)[::-1].copy()


def decode(ids: np.ndarray) -> str:
    return _ID2CHAR[np.asarray(ids, dtype=np.int64)].tobytes().decode("ascii")


def canonicalize_transcript(seq: str) -> str:
    """Uppercase; non-ACGT -> N (reference: RefSeqPolicy.h)."""
    return _CANON[to_bytes(seq)].tobytes().decode("ascii")


def canonicalize_genome(seq: str) -> str:
    """Case-preserving genome canonicalization (reference: extractRef.cpp check())."""
    b = to_bytes(seq)
    out = _GCANON[b]
    if (out == 0).any():
        bad = b[out == 0][0]
        raise ValueError(f"FASTA contains a non-alphabetic character {chr(bad)!r}")
    return out.tobytes().decode("ascii")


def n_to_g(seq: str) -> str:
    """N -> G conversion for aligner indices (reference: AlignerRefSeqPolicy.h)."""
    return seq.replace("N", "G")


def revcomp(seq: str) -> str:
    """Reverse complement preserving case (reference: utils.h getOpp)."""
    return _COMPLEMENT[to_bytes(seq)][::-1].tobytes().decode("ascii")
