"""Minimal FASTA / FASTQ IO helpers."""

from __future__ import annotations

from typing import Iterator, Tuple


def read_fasta(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (header, seq) pairs; header is everything after '>'."""
    header = None
    chunks = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if header is not None:
                    yield header, "".join(chunks)
                header = line[1:]
                chunks = []
            else:
                chunks.append(line)
    if header is not None:
        yield header, "".join(chunks)


def write_fasta(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")


def read_fastq(path: str) -> Iterator[Tuple[str, str, str]]:
    """Yield (name, seq, qual)."""
    with open(path) as f:
        while True:
            h = f.readline()
            if not h:
                return
            seq = f.readline().rstrip("\n")
            plus = f.readline()
            qual = f.readline().rstrip("\n")
            if not h.startswith("@") or not plus.startswith("+"):
                raise ValueError(f"{path} does not look like a FASTQ file")
            yield h[1:].rstrip("\n"), seq, qual


def write_fastq(path: str, records) -> None:
    with open(path, "w") as f:
        for name, seq, qual in records:
            f.write(f"@{name}\n{seq}\n+\n{qual}\n")
