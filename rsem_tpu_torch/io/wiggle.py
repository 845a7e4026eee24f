"""ZW-weighted read-depth tracks (rsem-bam2wig / rsem-bam2readdepth).

Behavioral parity with wiggle.cpp/wiggle.h:
  - each alignment adds its ZW posterior weight (or 1.0 with
    --no-fractional-weight; records *without* a ZW tag are skipped in
    fractional mode, wiggle.cpp:21-24) to every reference base covered by an
    M cigar op; D/N advance without adding depth
  - UCSC track output: fixedStep runs over spans with depth >= 0.0095,
    values printed %.2f (wiggle.cpp:99-121)
  - readdepth output: name, length, space-separated per-base depths; targets
    with no alignments print NA (wiggle.cpp:124-139)

Depth accumulation is vectorized: M spans become +w/-w events in a
difference array, one cumsum per target.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, TextIO, Tuple

import numpy as np

from .bamio import open_rec_reader

DEPTH_THRESHOLD = 0.0095  # wiggle.cpp:104


def build_depths(
    bam_path: str, no_fractional_weight: bool = False
) -> Tuple[List[str], List[int], Dict[int, np.ndarray]]:
    """Returns (target_names, target_lens, {tid: depth array}); targets with
    no alignments are absent from the dict."""
    reader = open_rec_reader(bam_path)
    names = reader.header.target_names
    lens = reader.header.target_lens

    events: Dict[int, list] = {}
    for rec in reader:
        if not rec.is_mapped or rec.tid < 0:
            continue
        if no_fractional_weight:
            w = 1.0
        else:
            zw = rec.get_tag("ZW")
            if zw is None:
                continue
            w = float(zw)
        ev = events.setdefault(rec.tid, [])
        pos = rec.pos
        for ln, op in rec.cigar_ops():
            if op == "M":
                ev.append((pos, w))
                ev.append((pos + ln, -w))
                pos += ln
            elif op in "DN=X":
                pos += ln
    reader.close()

    depths: Dict[int, np.ndarray] = {}
    for tid, ev in events.items():
        d = np.zeros(lens[tid] + 1, dtype=np.float64)
        arr = np.asarray(ev)
        np.add.at(d, arr[:, 0].astype(np.int64), arr[:, 1])
        depths[tid] = np.cumsum(d[:-1])
    return names, lens, depths


def write_wiggle(
    out: TextIO,
    track_name: str,
    names: List[str],
    lens: List[int],
    depths: Dict[int, np.ndarray],
):
    out.write(
        f'track type=wiggle_0 name="{track_name}" description="{track_name}" '
        "visibility=full\n"
    )
    for tid in range(len(names)):
        depth = depths.get(tid)
        if depth is None:
            continue
        _write_fixed_step_runs(out, names[tid], depth)


def _write_fixed_step_runs(out: TextIO, name: str, depth: np.ndarray):
    above = depth >= DEPTH_THRESHOLD
    if not above.any():
        return
    padded = np.concatenate([[False], above, [False]])
    d = np.diff(padded.astype(np.int8))
    starts = np.nonzero(d == 1)[0]
    ends = np.nonzero(d == -1)[0]
    for s, e in zip(starts, ends):
        out.write(f"fixedStep chrom={name} start={s + 1} step=1\n")
        out.write("\n".join(f"{v:.2f}" for v in depth[s:e]))
        out.write("\n")


def write_readdepth(
    out: TextIO,
    names: List[str],
    lens: List[int],
    depths: Dict[int, np.ndarray],
):
    for tid in range(len(names)):
        depth = depths.get(tid)
        if depth is None:
            out.write(f"{names[tid]}\t{lens[tid]}\tNA\n")
        else:
            vals = " ".join(f"{v:g}" for v in depth)
            out.write(f"{names[tid]}\t{lens[tid]}\t{vals}\n")


def bam2wig(bam_path: str, out_path: str, track_name: str,
            no_fractional_weight: bool = False):
    names, lens, depths = build_depths(bam_path, no_fractional_weight)
    with open(out_path, "w") as f:
        write_wiggle(f, track_name, names, lens, depths)


def bam2readdepth(bam_path: str, out_path: str,
                  no_fractional_weight: bool = False):
    names, lens, depths = build_depths(bam_path, no_fractional_weight)
    with open(out_path, "w") as f:
        write_readdepth(f, names, lens, depths)
