"""Synthetic dataset generation for benchmarks, compile checks and tests.

Builds a Reference + AlignmentBundle directly in memory (no SAM round-trip):
reads are true substrings of transcripts (so likelihoods are realistic), with
extra decoy alignments to exercise multi-mapping.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .io.hits import CntStats, HitArrays
from .io.reads import PairedReadArrays, ReadArrays, ReadStats
from .io.sam import AlignmentBundle
from .model.generative import GenerativeModel
from .model.spec import ModelSpec
from .refprep.reference import Reference
from .utils.seq import decode


def synthetic_arrays_fast(
    n_reads: int = 500_000,
    M: int = 20_000,
    read_len: int = 100,
    tx_len: int = 2000,
    paired: bool = False,
    has_qual: bool = True,
    mean_extra_hits: float = 1.5,
    seed: int = 0,
    collect_qual_stats: bool = False,
    skewed_hits: bool = False,
    consistent_reads: bool = True,
) -> Tuple[Reference, AlignmentBundle, ModelSpec, GenerativeModel]:
    """Fully vectorized generator for benchmarks. With consistent_reads
    (default, r4) read sequences copy their first alignment's target
    substring with 0.5% errors — the same distribution as the measured
    reference workload (tools/measure_baseline.py), so EM posteriors are
    realistic; consistent_reads=False keeps the r1-r3 random-content
    behavior (arbitrary likelihoods, identical compute shape).
    collect_qual_stats=False skips the QualDist transition counting (only
    needed by the simulator / .model file, not by any kernel)."""
    rng = np.random.default_rng(seed)
    model_type = (2 if paired else 0) + (1 if has_qual else 0)

    lens = rng.integers(max(read_len * 3, tx_len // 2), tx_len + 1, size=M)
    codes = rng.integers(0, 4, size=int(lens.sum()), dtype=np.int64).astype(np.uint8)
    ref = Reference.__new__(Reference)
    ref.names = [""] + [f"TX{i:05d}" for i in range(M)]
    ref.full_len = np.concatenate([[0], lens]).astype(np.int64)
    ref.tot_len = ref.full_len.copy()
    ref.mask_start = ref.full_len.copy()
    ref.codes = codes
    ref.offsets = np.zeros(M + 2, dtype=np.int64)
    np.cumsum(ref.tot_len, out=ref.offsets[1:])

    n_hits_per = 1 + rng.poisson(mean_extra_hits, size=n_reads)
    if skewed_hits:
        # realistic skew (SURVEY §5 "long-context" axes): most reads map
        # 1-4 places, a heavy tail multimaps up to the reference's bowtie
        # -m 200 cap (rsem-calculate-expression:40)
        tail = rng.random(n_reads) < 0.05
        n_hits_per[tail] = np.clip(
            np.exp(rng.uniform(np.log(4), np.log(200), size=int(tail.sum()))),
            4, 200,
        ).astype(n_hits_per.dtype)
    H = int(n_hits_per.sum())
    rid = np.repeat(np.arange(n_reads, dtype=np.int32), n_hits_per)
    sid = rng.integers(1, M + 1, size=H).astype(np.int32)
    dirs = rng.integers(0, 2, size=H).astype(np.int8)
    if paired:
        ins = rng.integers(2 * read_len, 3 * read_len, size=H).astype(np.int32)
        ins = np.minimum(ins, ref.tot_len[sid].astype(np.int32))
        span = ins
    else:
        ins = None
        span = np.full(H, read_len, dtype=np.int32)
    max_pos = (ref.tot_len[sid] - span).astype(np.int64)
    pos = (rng.random(H) * (max_pos + 1)).astype(np.int32)
    offsets = np.zeros(n_reads + 1, dtype=np.int64)
    np.cumsum(n_hits_per, out=offsets[1:])
    hits = HitArrays(rid, sid, dirs, pos, ins, offsets)

    def make_quals():
        return (
            rng.integers(20, 40, size=(n_reads, read_len), dtype=np.int64).astype(np.uint8)
            if has_qual else None
        )

    def reads_from_hits(mate2: bool = False):
        """Read codes copied from the FIRST alignment's target substring
        with 0.5% errors (same distribution as tools/measure_baseline.py's
        reference dataset, so hit likelihoods are realistic and the EM
        posterior is non-degenerate). `pos` is STRAND-LOCAL (SamParser.h:
        136-142): dir=1 reads walk ref[tot-1-pos-j] reverse-complemented."""
        if consistent_reads:
            fh = offsets[:-1]  # first hit of each read
            s, p, d = sid[fh], pos[fh].astype(np.int64), dirs[fh]
            tl = ref.tot_len[s]
            L = read_len
            if not mate2:
                start = np.where(d == 0, p, tl - p - L)
                flip = d == 1
            else:
                i2 = ins[fh].astype(np.int64)
                start = np.where(d == 0, p + i2 - L, tl - p - i2)
                flip = d == 0
            gather = (ref.offsets[s] + start)[:, None] + np.arange(L)[None, :]
            rc = ref.codes[gather].astype(np.uint8).copy()
            rc[flip] = 3 - rc[flip, ::-1]
            err = rng.random((n_reads, L)) < 0.005
            rc = np.where(
                err, rng.integers(0, 4, size=(n_reads, L)), rc
            ).astype(np.uint8)
        else:
            rc = rng.integers(0, 4, size=(n_reads, read_len),
                              dtype=np.int64).astype(np.uint8)
        rlens = np.full(n_reads, read_len, dtype=np.int32)
        return ReadArrays(rc, rlens, make_quals(),
                          np.zeros(n_reads, dtype=bool))

    m1 = reads_from_hits()
    if paired:
        m2 = reads_from_hits(mate2=True)
        reads = PairedReadArrays.build(m1, m2, 25)
    else:
        reads = m1

    stats = {i: ReadStats() for i in range(3)}
    sq = m1.quals if collect_qual_stats else None
    stats[1].add_reads(m1.codes, m1.lens, sq, np.zeros(n_reads, bool), False)
    if paired:
        sq2 = m2.quals if collect_qual_stats else None
        stats[1].add_reads(m2.codes, m2.lens, sq2, np.zeros(n_reads, bool), False)

    cnt = CntStats(N0=0, N1=n_reads, N2=0, n_hits=H, read_type=model_type, hist={})
    bundle = AlignmentBundle(model_type, reads, hits, stats, cnt,
                             np.zeros(0, dtype=np.int64))
    spec = ModelSpec(model_type=model_type, seed_len=25, has_polya=False)
    model = GenerativeModel(spec, ref)
    model.estimate_from_stats(stats)
    return ref, bundle, spec, model


def synthetic_dataset(
    n_reads: int = 1000,
    M: int = 50,
    read_len: int = 50,
    tx_len: int = 500,
    paired: bool = False,
    has_qual: bool = True,
    mean_extra_hits: float = 1.0,
    n0: int = 5,
    seed: int = 0,
    est_rspd: bool = False,
) -> Tuple[Reference, AlignmentBundle, ModelSpec, GenerativeModel]:
    rng = np.random.default_rng(seed)
    model_type = (2 if paired else 0) + (1 if has_qual else 0)

    lens = rng.integers(max(tx_len // 2, read_len * 2 + 10), tx_len + 1, size=M)
    seqs = [decode(rng.integers(0, 4, size=l)) for l in lens]
    names = [f"TX{i:05d}" for i in range(M)]
    ref = Reference(names, seqs, [0] * M)

    # expression skewed like real data
    theta = rng.dirichlet(np.full(M, 0.3))
    src = rng.choice(M, size=n_reads, p=theta) + 1

    seqs1, quals1, seqs2, quals2 = [], [], [], []
    per_read_hits = []
    for i in range(n_reads):
        sid = int(src[i])
        tl = int(ref.tot_len[sid])
        if paired:
            ins = int(rng.integers(2 * read_len, min(tl, 3 * read_len) + 1)) \
                if tl >= 2 * read_len else tl
            pos = int(rng.integers(0, tl - ins + 1))
            frag = ref.seq_codes(sid)[pos : pos + ins]
            m1c = frag[:read_len].copy()
            m2c = frag[-read_len:][::-1].copy()
            m2c = np.where(m2c < 4, 3 - m2c, m2c).astype(np.uint8)
            seqs1.append(m1c)
            seqs2.append(m2c)
            hits = [(sid, pos, ins)]
        else:
            pos = int(rng.integers(0, tl - read_len + 1))
            seqs1.append(ref.seq_codes(sid)[pos : pos + read_len].copy())
            hits = [(sid, pos)]
        if has_qual:
            quals1.append(rng.integers(20, 40, size=read_len).astype(np.uint8))
            if paired:
                quals2.append(rng.integers(20, 40, size=read_len).astype(np.uint8))
        # decoy multi-map hits
        n_extra = int(rng.poisson(mean_extra_hits))
        for _ in range(n_extra):
            dsid = int(rng.integers(1, M + 1))
            dtl = int(ref.tot_len[dsid])
            if paired:
                dins = min(hits[0][2], dtl)
                if dtl < dins:
                    continue
                dpos = int(rng.integers(0, dtl - dins + 1))
                hits.append((dsid, dpos, dins))
            else:
                if dtl < read_len:
                    continue
                dpos = int(rng.integers(0, dtl - read_len + 1))
                hits.append((dsid, dpos))
        per_read_hits.append(hits)

    m1 = ReadArrays.build(seqs1, quals1 if has_qual else None, False, 25)
    if paired:
        m2 = ReadArrays.build(seqs2, quals2 if has_qual else None, False, 25)
        reads = PairedReadArrays.build(m1, m2, 25)
    else:
        reads = m1
    hits = HitArrays.from_lists(per_read_hits, paired)

    stats = {i: ReadStats() for i in range(3)}
    if paired:
        stats[1].add_reads(m1.codes, m1.lens, m1.quals, reads.lq, False)
        stats[1].add_reads(m2.codes, m2.lens, m2.quals, reads.lq, False)
    else:
        stats[1].add_reads(m1.codes, m1.lens, m1.quals, m1.lq, False)
    # unalignable reads -> noise stats
    if n0 > 0:
        codes0 = rng.integers(0, 4, size=(n0, read_len)).astype(np.uint8)
        lens0 = np.full(n0, read_len, dtype=np.int32)
        q0 = rng.integers(20, 40, size=(n0, read_len)).astype(np.uint8) \
            if has_qual else None
        lq0 = np.zeros(n0, dtype=bool)
        stats[0].add_reads(codes0, lens0, q0, lq0, True)
        if paired:
            stats[0].add_reads(codes0, lens0, q0, lq0, True)

    hist = {}
    for h in per_read_hits:
        hist[len(h)] = hist.get(len(h), 0) + 1
    cnt = CntStats(
        N0=n0, N1=n_reads, N2=0, n_unique=0, n_multi=0,
        n_iso_multi=hits.n_isoform_multi_reads(), n_hits=hits.n_hits,
        read_type=model_type, hist=hist,
    )
    bundle = AlignmentBundle(model_type, reads, hits, stats, cnt,
                             np.zeros(0, dtype=np.int64))

    spec = ModelSpec(model_type=model_type, seed_len=25, has_polya=False,
                     est_rspd=est_rspd)
    model = GenerativeModel(spec, ref)
    model.estimate_from_stats(stats)
    return ref, bundle, spec, model


def synthetic_gibbs_hits(N: int, M: int, seed: int, max_hits: int,
                         min_hits: int = 1):
    """(HitArrays, log_conprb [H], log_ncp [N]) for the Gibbs sampler: N
    reads of min_hits..max_hits alignments around a known uneven theta,
    with duplicate sids inside a read as real parsers give (the generator
    of tests/test_pallas_gibbs.py:15-49)."""
    rng = np.random.default_rng(seed)
    theta = rng.dirichlet(np.full(M, 0.4))
    nh = rng.integers(min_hits, max_hits + 1, size=N)
    offs = np.concatenate([[0], np.cumsum(nh)])
    H = int(offs[-1])
    sid = np.empty(H, dtype=np.int32)
    lcp = np.empty(H)
    for i in range(N):
        true = rng.choice(M, p=theta) + 1
        cands = np.unique(
            np.concatenate([[true], rng.integers(1, M + 1, nh[i] - 1)]))
        cands = cands[: nh[i]]
        k = len(cands)
        sid[offs[i]: offs[i] + k] = cands
        lcp[offs[i]: offs[i] + k] = rng.normal(-20, 2, k)
        for j in range(k, nh[i]):
            sid[offs[i] + j] = cands[j % k]
            lcp[offs[i] + j] = rng.normal(-21, 2)
    lnp = rng.normal(-40, 3, N)
    hits = HitArrays(rid=np.repeat(np.arange(N, dtype=np.int32), nh),
                     sid=sid, dir=np.zeros(H, dtype=np.int8),
                     pos=np.zeros(H, dtype=np.int32), insert_len=None,
                     read_offsets=offs.astype(np.int64))
    return hits, lcp, lnp


def pair_hits(ratios, reads_per_pair: int):
    """(HitArrays, log_conprb [H], log_ncp [N]) of len(ratios) pairs of
    isoforms: pair p holds sids 2p+1 and 2p+2 and reads_per_pair reads,
    each aligned to both with conprbs ratios[p] : 1 and no noise slot. With
    unit pseudo-counts the collapsed posterior of a pair's count on its
    first member is exact (`pair_posterior`)."""
    ratios = np.asarray(ratios, dtype=np.float64)
    N = len(ratios) * reads_per_pair
    pair = np.arange(N) // reads_per_pair
    sid = np.stack([2 * pair + 1, 2 * pair + 2], 1).reshape(-1)
    lcp = np.zeros((N, 2))
    lcp[:, 0] = np.log(ratios[pair])
    hits = HitArrays(rid=np.repeat(np.arange(N, dtype=np.int32), 2),
                     sid=sid.astype(np.int32), dir=np.zeros(2 * N, np.int8),
                     pos=np.zeros(2 * N, np.int32), insert_len=None,
                     read_offsets=np.arange(0, 2 * N + 1, 2, dtype=np.int64))
    return hits, lcp.reshape(-1), np.full(N, -np.inf)


def pair_posterior(ratio: float, n: int) -> Tuple[float, float]:
    """Mean and SD of the exact posterior of a `pair_hits` pair's count c
    on its first member: summed over the assignments with that count, the
    collapsed joint gives C(n, c) c! (n - c)! ratio^c = n! ratio^c, so
    p(c) is proportional to ratio^c on 0..n (uniform for ratio 1)."""
    c = np.arange(n + 1)
    logp = c * np.log(float(ratio))
    p = np.exp(logp - logp.max())
    p /= p.sum()
    mean = float((p * c).sum())
    return mean, float(np.sqrt((p * (c - mean) ** 2).sum()))


def pair_tile_max(layout) -> int:
    """The largest number of one `pair_hits` pair's reads in one tile of a
    Gibbs layout (a read's pair from its first slot's sid)."""
    import torch

    most = 0
    for part in layout.parts:
        sid = part.sid.view(part.n_tiles, part.reads_per_tile, part.K)
        for t, f in enumerate(part.fill):
            if f:
                pair = (sid[t, :int(f), 0].long() - 1) // 2
                most = max(most, int(torch.bincount(pair).max()))
    return most


def relabel_layout(layout, table, factor: int = 10):
    """The same Gibbs layout with every slot sid s relabelled factor * s and
    the chains' count table widened to T = factor * M + 1 (entry factor * s
    holds entry s; the others hold 1.0 and are never touched). Tiles, read
    order and sampling stay as they were; only the table is larger.
    Returns (layout, table)."""
    import torch

    from .ops.gibbs import GibbsLayout, GibbsPart

    parts = [GibbsPart(p.sid * factor, p.cps, p.ncs, p.K, p.n_tiles,
                       p.fill) for p in layout.parts]
    C, T = table.shape
    wide = torch.ones((C, factor * (T - 1) + 1), dtype=table.dtype,
                      device=table.device)
    wide[:, ::factor] = table
    return (GibbsLayout(parts, factor * layout.M, layout.n_reads,
                        layout.n_noise_fixed), wide)


_NIBBLES = np.array([1, 2, 4, 8], dtype=np.uint8)  # BAM codes of A C G T


def synthetic_bam(path: str, n_reads: int, M: int = 2000,
                  read_len: int = 100, mean_hits: float = 2.5,
                  frac_n0: float = 0.02, seed: int = 0,
                  chunk_reads: int = 1 << 18) -> int:
    """A single-end BAM for ingest runs, encoded in bulk with numpy and
    written with the port's BamRecWriter: `n_reads` reads of random bases
    (quality 40), a `frac_n0` share unmapped, the others aligned
    min(1 + Geometric(1 / (mean_hits - 1)), 20) times to targets t0..t{M-1}
    of 2,000 bases, forward or reverse. Each read's records are adjacent:
    the mapped reads first, then the unmapped ones. Returns the number of
    records."""
    from .io.bamio import BamHeader, BamRecWriter

    if read_len % 2 or read_len >= 2000:
        raise ValueError("read_len must be even and below 2,000")
    rng = np.random.default_rng(seed)
    tx_len = 2000
    mapped = rng.random(n_reads) >= frac_n0
    k = np.minimum(1 + rng.geometric(1.0 / (mean_hits - 1.0),
                                     size=n_reads), 20)
    header = BamHeader("@HD\tVN:1.0\n", [f"t{i}" for i in range(M)],
                       [tx_len] * M)

    def records(ids, n_hits, with_cigar):
        """Encoded records of reads `ids`, each repeated n_hits times."""
        L = read_len
        fields = [("bs", "<i4"), ("ref", "<i4"), ("pos", "<i4"),
                  ("lrn", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                  ("ncig", "<u2"), ("flag", "<u2"), ("lseq", "<i4"),
                  ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4"),
                  ("name", "u1", (10,))]
        fields += [("cig", "<u4")] if with_cigar else []
        fields += [("seq", "u1", (L // 2,)), ("qual", "u1", (L,))]
        dt = np.dtype(fields)
        nib = _NIBBLES[rng.integers(0, 4, size=(len(ids), L))]
        seq = (nib[:, 0::2] << 4) | nib[:, 1::2]
        digits = (ids[:, None] // 10 ** np.arange(7, -1, -1)) % 10 + 48
        name = np.concatenate([np.full((len(ids), 1), ord("r")), digits,
                               np.zeros((len(ids), 1))], axis=1)
        row = np.repeat(np.arange(len(ids)), n_hits)
        rec = np.zeros(len(row), dtype=dt)
        rec["bs"] = dt.itemsize - 4
        rec["lrn"] = 10
        rec["lseq"] = L
        rec["nref"], rec["npos"] = -1, -1
        rec["name"] = name[row]
        rec["seq"] = seq[row]
        rec["qual"] = 40
        if with_cigar:
            j = np.arange(len(row)) - np.repeat(np.cumsum(n_hits) - n_hits,
                                                n_hits)
            rec["ref"] = rng.integers(0, M, size=len(row))
            pos = rng.integers(0, tx_len - L, size=len(row))
            rec["pos"] = pos
            rec["bin"] = 4681 + (pos >> 14)
            rec["ncig"] = 1
            rec["flag"] = np.where((ids[row] + j) % 3 == 0, 0, 16)
            rec["cig"] = L << 4  # L M
        else:
            rec["ref"], rec["pos"], rec["bin"], rec["flag"] = -1, -1, 4680, 4
        return rec.tobytes()

    n_rec = 0
    with BamRecWriter(path, header, level=1) as w:
        for with_cigar in (True, False):
            ids = np.flatnonzero(mapped == with_cigar)
            for a in range(0, len(ids), chunk_reads):
                sl = ids[a:a + chunk_reads]
                n_hits = k[sl] if with_cigar else np.ones(len(sl), np.int64)
                w.write_raw(records(sl, n_hits, with_cigar))
                n_rec += int(n_hits.sum())
    return n_rec


# ------------------------------------------------------------------ #
# checks of simulated reads (tests and the card's smoke run)          #
# ------------------------------------------------------------------ #
def two_sample_counts_ok(a: np.ndarray, b: np.ndarray, n: int,
                         k: float = 4.5) -> np.ndarray:
    """Per entry: two draws of n reads, counts a and b, agree within
    k sd of their difference + 3 (tests/test_parity_extra.py:342-346)."""
    p = (a + b) / (2 * n)
    sd = np.sqrt(n * p * (1 - p))
    return np.abs(a - b) <= k * sd * np.sqrt(2) + 3


def counts_vs_theta(counts: np.ndarray, theta: np.ndarray, n: int):
    """(largest |O - E| / (6 sd + 3) over entries, chi-square p) of read
    counts O against E = n * theta. The + 3 keeps entries with an expected
    count below 1, where the normal tail does not hold, from false alarms;
    the chi-square runs over entries with E >= 5 plus one pooled bin of
    the rest."""
    import torch

    theta = np.asarray(theta, np.float64) / np.sum(theta)
    e = n * theta
    sd = np.sqrt(e * (1 - theta))
    worst = float(np.max(np.abs(counts - e) / (6 * sd + 3)))
    big = e >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(e[big], e[~big].sum())
    if exp[-1] < 5:
        obs, exp = obs[:-1], exp[:-1]
    chi2 = float(((obs - exp) ** 2 / exp).sum())
    p = float(torch.special.gammaincc(
        torch.tensor((len(obs) - 1) / 2, dtype=torch.float64),
        torch.tensor(chi2 / 2, dtype=torch.float64)))
    return worst, p


def truncated_length_hist(ld, refL: np.ndarray,
                          weights: np.ndarray) -> np.ndarray:
    """Expected histogram (index = length) of weights[i] draws from the
    LenDist `ld` truncated at refL[i] (-1: the whole support), as the
    simulator draws fragment and mate lengths."""
    pdf, cdf = ld.device_arrays(ld.lb, ld.ub)
    span = ld.ub - ld.lb
    out = np.zeros(ld.ub + 1)
    for r, w in zip(refL, weights):
        dl = span if r < 0 else min(max(min(ld.ub, int(r)) - ld.lb, 0), span)
        if w and dl > 0 and cdf[dl] > 0:
            out[ld.lb + 1: ld.lb + dl + 1] += w * pdf[1: dl + 1] / cdf[dl]
    return out


def hist_vs_expected(obs: np.ndarray, exp: np.ndarray) -> float:
    """Largest |O - E| / (5 sd + 3) over the bins of two histograms
    (index = length); at most 1 passes."""
    k = max(len(obs), len(exp))
    obs = np.pad(np.asarray(obs, np.float64), (0, k - len(obs)))
    exp = np.pad(np.asarray(exp, np.float64), (0, k - len(exp)))
    return float(np.max(np.abs(obs - exp) / (5 * np.sqrt(exp) + 3)))


def provenance_sam(refs: Reference, fastq: str, sam: str,
                   fastq2: Optional[str] = None, also=None) -> np.ndarray:
    """Write a SAM of each simulated read's true alignment, taken from its
    name rid_dir_sid_pos[_insertL] (noise reads unmapped; strand-local pos
    turned into the forward-strand POS, SamParser.h:136-142), and return the
    per-transcript counts [M+1] of the names.

    fastq2: the mate-2 FASTQ of paired-end reads (mates of one fragment:
    mate 1 on the read's strand at its start, mate 2 on the other strand at
    its end). also(sid, start, length) -> [(sid2, start2), ...]: other
    transcripts the read aligns to, written after the true alignment as
    secondary records (flag 256); start and start2 are 0-based forward
    positions of the fragment (single end: the read) on sid and sid2."""
    comp = str.maketrans("ACGTN", "TGCAN")
    lines = ["@HD\tVN:1.0"] + [
        f"@SQ\tSN:{refs.names[i]}\tLN:{int(refs.tot_len[i])}"
        for i in range(1, refs.M + 1)]
    counts = np.zeros(refs.M + 1)
    with open(fastq) as f:
        rec = f.read().splitlines()
    mates2 = [None] * (len(rec) // 4)
    if fastq2 is not None:
        with open(fastq2) as f:
            rec2 = f.read().splitlines()
        mates2 = list(zip(rec2[1::4], rec2[3::4]))
    for name, s, q, m2 in zip(rec[0::4], rec[1::4], rec[3::4], mates2):
        fields = name[1:].split("/")[0].split("_")
        rid, d, sid, pos = (int(x) for x in fields[:4])
        counts[sid] += 1
        if sid == 0:
            if m2 is None:
                lines.append(f"N{rid}\t4\t*\t0\t0\t*\t*\t0\t0\t{s}\t{q}")
            else:
                lines.append(f"N{rid}\t77\t*\t0\t0\t*\t*\t0\t0\t{s}\t{q}")
                lines.append(f"N{rid}\t141\t*\t0\t0\t*\t*\t0\t0\t{m2[0]}"
                             f"\t{m2[1]}")
            continue
        L = len(s)
        flen = L if m2 is None else int(fields[4])
        start = pos if d == 0 else int(refs.tot_len[sid]) - pos - flen
        hits = [(sid, start)]
        if also is not None:
            hits += also(sid, start, flen)
        s_rc, q_r = s.translate(comp)[::-1], q[::-1]
        for k, (t, st) in enumerate(hits):
            tname, sec = refs.names[t], 256 if k else 0
            if m2 is None:
                flag, s_out, q_out = (0, s, q) if d == 0 else (16, s_rc, q_r)
                lines.append(f"S{rid}\t{flag | sec}\t{tname}\t{st + 1}\t255\t"
                             f"{L}M\t*\t0\t0\t{s_out}\t{q_out}")
                continue
            s2, q2 = m2
            L2 = len(s2)
            s2_rc, q2_r = s2.translate(comp)[::-1], q2[::-1]
            if d == 0:  # mate 1 forward at the start, mate 2 reverse
                p1, p2, r1 = st, st + flen - L2, False
                m1 = (s, q)
                m2_out = (s2_rc, q2_r)
            else:  # mate 1 reverse at the end, mate 2 forward
                p1, p2, r1 = st + flen - L, st, True
                m1 = (s_rc, q_r)
                m2_out = (s2, q2)
            f1 = 0x43 | (0x10 if r1 else 0x20) | sec
            f2 = 0x83 | (0x20 if r1 else 0x10) | sec
            t1 = flen if p1 <= p2 else -flen
            lines.append(f"S{rid}\t{f1}\t{tname}\t{p1 + 1}\t255\t{L}M\t=\t"
                         f"{p2 + 1}\t{t1}\t{m1[0]}\t{m1[1]}")
            lines.append(f"S{rid}\t{f2}\t{tname}\t{p2 + 1}\t255\t{L2}M\t=\t"
                         f"{p1 + 1}\t{-t1}\t{m2_out[0]}\t{m2_out[1]}")
    with open(sam, "w") as f:
        f.write("\n".join(lines) + "\n")
    return counts


def allele_siblings(ta):
    """`also` for provenance_sam on an allele-specific reference: a read of
    one allele aligns to every other allele of its transcript at its own
    position (alleles differ by SNPs only), as an aligner that allows the
    SNPs' mismatches reports it. ta: transcript -> allele GroupInfo."""
    def also(sid, start, length):
        b, e = ta.span(ta.gid_at(sid))
        return [(a, start) for a in range(b, e) if a != sid]
    return also


class SharedExonSiblings:
    """`also` for provenance_sam on a genome reference: a fragment also
    aligns to another isoform of its gene where it lies wholly in exons that
    isoform shares at the same genome positions, consecutively (the same
    splice structure over the fragment). Computed from the exon coordinates
    of the .ti transcripts, not through tbam2gbam. Every such alignment
    covers the fragment's own genome positions, so in genome coordinates a
    read's alignments collapse to one; `n_siblings` counts the alignments
    added."""

    def __init__(self, transcripts):
        self.ts = transcripts
        self.gpos = [None]  # sid -> genome position (0-based) of each base
        self.inv = [None]  # sid -> (lowest position, base index by position)
        self.by_gene = {}
        for sid, tr in enumerate(transcripts.transcripts, start=1):
            g = np.concatenate([np.arange(a - 1, b) for a, b in
                                tr.structure])
            g = g[::-1] if tr.strand == "-" else g
            lo = int(g.min())
            inv = np.full(int(g.max()) - lo + 1, -1, dtype=np.int64)
            inv[g - lo] = np.arange(len(g))
            self.gpos.append(g)
            self.inv.append((lo, inv))
            self.by_gene.setdefault(tr.gene_id, []).append(sid)
        self.n_siblings = 0

    def __call__(self, sid, start, length):
        g = self.gpos[sid][start:start + length]
        out = []
        for sib in self.by_gene[self.ts.transcripts[sid - 1].gene_id]:
            lo, inv = self.inv[sib]
            if sib == sid or not lo <= g[0] < lo + len(inv):
                continue
            x0 = int(inv[g[0] - lo])
            if x0 >= 0 and np.array_equal(self.gpos[sib][x0:x0 + length], g):
                out.append((sib, x0))
        self.n_siblings += len(out)
        return out


# ------------------------------------------------------------------ #
# references for the allele and genome-BAM runs                       #
# ------------------------------------------------------------------ #
_ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def synthetic_allele_reference(d: str, n_genes: int, seed: int,
                               tx_len: int = 2000, two_alleles: float = 0.9,
                               snp_every: int = 250) -> None:
    """Write `d`/alleles.fa and `d`/amap.txt (allele-to-gene map): genes of
    two transcripts of tx_len random bases; a share two_alleles of the
    transcripts has two alleles that differ at seeded SNPs (a base drawn
    from the other three, one per snp_every bases on average), the rest
    one allele. Ids: gene G<g>, transcript G<g>_T<t>, allele
    G<g>_T<t>_A<a>."""
    import os

    rng = np.random.default_rng(seed)
    fa, amap = [], []
    for g in range(n_genes):
        for t in range(2):
            tid = f"G{g:05d}_T{t}"
            seq = _ACGT[rng.integers(0, 4, tx_len)]
            alleles = [seq]
            if rng.random() < two_alleles:
                alt = seq.copy()
                snp = np.flatnonzero(rng.random(tx_len) < 1.0 / snp_every)
                shift = rng.integers(1, 4, len(snp))
                code = np.searchsorted(_ACGT, alt[snp])
                alt[snp] = _ACGT[(code + shift) % 4]
                alleles.append(alt)
            for a, s in enumerate(alleles):
                aid = f"{tid}_A{a}"
                fa.append(f">{aid}\n{s.tobytes().decode()}\n")
                amap.append(f"G{g:05d}\t{tid}\t{aid}\n")
    with open(os.path.join(d, "alleles.fa"), "w") as f:
        f.write("".join(fa))
    with open(os.path.join(d, "amap.txt"), "w") as f:
        f.write("".join(amap))


def synthetic_genome(d: str, seed: int, n_chrom: int = 4,
                     chrom_len: int = 1_000_000, n_genes: int = 1000,
                     n_single: int = 0) -> None:
    """Write `d`/genome.fa (n_chrom chromosomes of random bases) and
    `d`/anno.gtf: n_genes genes spread evenly over the chromosomes, on
    either strand, each with two isoforms that share exons. Isoform 1 has
    2-6 exons of 150-400 bp with introns of 80-300 bp; isoform 2 skips one
    inner exon where there are three or more, else ends its last exon
    early. n_single of the genes, spread evenly, have isoform 1 alone,
    spanning at least pRSEM's TRAINING_GENE_MIN_LEN bp, so that they can
    enter its training set."""
    import os

    from .prsem.training import TRAINING_GENE_MIN_LEN

    rng = np.random.default_rng(seed)
    per_chrom = -(-n_genes // n_chrom)
    slot = chrom_len // per_chrom
    if slot < 100 + 6 * 400 + 5 * 300:
        raise ValueError("chromosomes too short for the genes")
    with open(os.path.join(d, "genome.fa"), "w") as f:
        for c in range(n_chrom):
            seq = _ACGT[rng.integers(0, 4, chrom_len)].tobytes().decode()
            f.write(f">chr{c + 1}\n")
            f.write("\n".join(seq[i:i + 60]
                              for i in range(0, chrom_len, 60)) + "\n")
    lines = []
    for g in range(n_genes):
        chrom, k = f"chr{g // per_chrom + 1}", g % per_chrom
        strand = "+" if rng.random() < 0.5 else "-"
        single = (g * n_single) // n_genes != ((g + 1) * n_single) // n_genes
        while True:
            n_ex = int(rng.integers(2, 7))
            lens = rng.integers(150, 401, n_ex)
            gaps = rng.integers(80, 301, n_ex - 1)
            if not single or lens.sum() + gaps.sum() >= TRAINING_GENE_MIN_LEN:
                break
        starts = k * slot + 101 + np.concatenate(
            [[0], np.cumsum(lens[:-1] + gaps)])
        ex1 = [(int(a), int(a + n - 1)) for a, n in zip(starts, lens)]
        if n_ex >= 3:
            skip = int(rng.integers(1, n_ex - 1))
            ex2 = ex1[:skip] + ex1[skip + 1:]
        else:
            ex2 = ex1[:-1] + [(ex1[-1][0], ex1[-1][1] - 60)]
        gid = f"gene{g:04d}"
        for t, exons in enumerate((ex1,) if single else (ex1, ex2)):
            for a, b in exons:
                lines.append(f'{chrom}\tsyn\texon\t{a}\t{b}\t.\t{strand}\t.\t'
                             f'gene_id "{gid}"; transcript_id "{gid}.{t}";\n')
    with open(os.path.join(d, "anno.gtf"), "w") as f:
        f.write("".join(lines))


def lognormal_tpm(M: int, seed: int, sigma: float = 1.5) -> np.ndarray:
    """[M+1] TPM (entry 0 zero) drawn lognormal from a seed."""
    rng = np.random.default_rng(seed)
    t = np.exp(rng.normal(0.0, sigma, M))
    return np.concatenate([[0.0], t / t.sum() * 1e6])


# ------------------------------------------------------------------ #
# BAM and BAI checks, independent of io/bamio.py and io/bamsort.py     #
# ------------------------------------------------------------------ #
def bam_records(path: str):
    """(raw records, virtual offsets, header bytes) of a BAM: the BGZF
    blocks inflated with zlib and the record stream split by block_size;
    a record's virtual offset is its block's file offset << 16 | its
    offset inside the block's data."""
    import struct
    import zlib

    buf = open(path, "rb").read()
    data, starts, coffs = [], [], []
    off = u = 0
    while off < len(buf):
        xlen = struct.unpack_from("<H", buf, off + 10)[0]
        bsize = struct.unpack_from("<H", buf, off + 16)[0] + 1
        raw = zlib.decompress(buf[off + 12 + xlen:off + bsize - 8], -15)
        if raw:
            data.append(raw)
            starts.append(u)
            coffs.append(off)
            u += len(raw)
        off += bsize
    stream = b"".join(data)
    starts = np.asarray(starts, dtype=np.int64)
    if stream[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM")
    l_text = struct.unpack_from("<i", stream, 4)[0]
    p = 8 + l_text
    n_ref = struct.unpack_from("<i", stream, p)[0]
    p += 4
    for _ in range(n_ref):
        p += 4 + struct.unpack_from("<i", stream, p)[0] + 4
    header = stream[:p]
    recs, voffs = [], []
    while p < len(stream):
        size = struct.unpack_from("<i", stream, p)[0]
        b = int(np.searchsorted(starts, p, side="right")) - 1
        voffs.append((coffs[b] << 16) | (p - int(starts[b])))
        recs.append(stream[p:p + 4 + size])
        p += 4 + size
    return recs, voffs, header


def record_span(raw: bytes):
    """(tid, pos, end) of a raw BAM record; end from the cigar's
    reference-consuming ops (M, D, N, =, X)."""
    import struct

    tid, pos, l_name, _mq, _bin, n_cig = struct.unpack_from("<iiBBHH", raw, 4)
    cig = np.frombuffer(raw, dtype="<u4", count=n_cig, offset=36 + l_name)
    ref_len = int((cig[np.isin(cig & 0xF, (0, 2, 3, 7, 8))] >> 4).sum())
    return tid, pos, pos + max(ref_len, 1)


def bai_finds_all(bam: str, bai: str) -> int:
    """Look every placed record of a coordinate-sorted BAM up through its
    BAI (SAM spec 5.2: the bins overlapping the record's span, their chunks
    and the 16 kb linear index); raise if one is not found. Returns the
    number of records looked up."""
    import struct

    idx = open(bai, "rb").read()
    if idx[:4] != b"BAI\x01":
        raise ValueError(f"{bai}: not a BAI")
    n_ref = struct.unpack_from("<i", idx, 4)[0]
    p, refs = 8, []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", idx, p)[0]
        p += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", idx, p)
            p += 8
            bins[b] = [struct.unpack_from("<QQ", idx, p + 16 * k)
                       for k in range(n_chunk)]
            p += 16 * n_chunk
        n_intv = struct.unpack_from("<i", idx, p)[0]
        lin = struct.unpack_from(f"<{n_intv}Q", idx, p + 4)
        p += 4 + 8 * n_intv
        refs.append((bins, lin))
    recs, voffs, _h = bam_records(bam)
    n = 0
    for raw, v in zip(recs, voffs):
        tid, beg, end = record_span(raw)
        if tid < 0:
            continue
        bins, lin = refs[tid]
        cand = [0]
        for shift, first in ((26, 1), (23, 9), (20, 73), (17, 585),
                             (14, 4681)):
            cand += range(first + (beg >> shift), first + ((end - 1) >> shift)
                          + 1)
        hit = any(lo <= v < hi for b in cand for lo, hi in bins.get(b, ()))
        win = beg >> 14
        if not hit or (win < len(lin) and lin[win] > v):
            raise ValueError(f"{bam}: record at {tid}:{beg} (virtual offset "
                             f"{v}) is not found through {bai}")
        n += 1
    return n


def synthetic_estep_inputs(n_reads: int, M: int, paired: bool,
                           est_rspd: bool, seed: int, device,
                           mean_extra_hits: float = 1.7, max_hits: int = 200,
                           gld_span: int = 999, B: int = 20):
    """(KernelConfig, ModelLoopData, lp [H], lnp [N], theta [M+1]) for one
    round of the fused loop's E-step statistics (ops/model_loop.
    estep_stats), drawn on `device`: reads of 1 + Poisson(mean_extra_hits)
    hits (at most max_hits), each hit's log conprb N(-30, 4) with 5% -inf,
    the noise one N(-34, 3), s0 the per-read max as the loop freezes it,
    theta Dirichlet-like with 1% zeros, fragment-length slots N(250, 60)
    and read-start bins denser at the 3' end, a second bin on 20% of the
    hits. Only the fields the E-step reads are filled."""
    import torch

    from .ops.layout import KernelConfig
    from .ops.model_loop import ModelLoopData

    g = torch.Generator(device=device)
    g.manual_seed(seed)

    def rand(n):
        return torch.rand(n, generator=g, device=device)

    def normal(n, mean, sd):
        return torch.randn(n, generator=g, device=device) * sd + mean

    nh = (1 + torch.poisson(torch.full((n_reads,), mean_extra_hits,
                                       device=device), generator=g)
          ).clamp(max=max_hits).long()
    off = torch.zeros(n_reads + 1, dtype=torch.int64, device=device)
    torch.cumsum(nh, 0, out=off[1:])
    H = int(off[-1])
    rid = torch.repeat_interleave(
        torch.arange(n_reads, dtype=torch.int32, device=device), nh,
        output_size=H)
    sid = (rand(H) * M).long().clamp(max=M - 1).int() + 1
    lp = normal(H, -30.0, 4.0)
    lp[rand(H) < 0.05] = float("-inf")
    lnp = normal(n_reads, -34.0, 3.0)
    s0 = torch.full((n_reads,), float("-inf"), device=device)
    s0 = torch.maximum(s0.scatter_reduce_(0, rid.long(), lp, "amax"), lnp)
    s0 = torch.where(torch.isfinite(s0), s0, 0.0)
    theta = -torch.log(rand(M + 1).clamp(min=1e-12))
    theta[rand(M + 1) < 0.01] = 0.0
    theta = (theta / theta.sum()).contiguous()
    cfg = KernelConfig(
        paired=paired, has_qual=True, est_rspd=est_rspd, use_mld=paired,
        B=B, seed_len=25, gld_lb=0, gld_ub=gld_span, mld_lb=0, mld_ub=1,
        max_read_len=50, pro_len=100)
    kw = {}
    if paired:
        kw["ins_idx"] = normal(H, 250.0, 60.0).round().clamp(
            0, gld_span - 1).int()
    if est_rspd:
        b0 = (rand(H).sqrt() * B).long().clamp(max=B - 1)
        kw.update(rs_b0=b0.int(), rs_w0=rand(H),
                  rs_b1=(b0 + 1).clamp(max=B - 1).int(),
                  rs_w1=torch.where(rand(H) < 0.2, rand(H), 0.0))
    data = ModelLoopData(
        lp_static=None, log_mw_h=None, lnp_static=None, sid=sid, rid=rid,
        read_offsets=off, s0=s0, pre=None, npro_c=None, n0=None, **kw)
    return cfg, data, lp, lnp, theta
