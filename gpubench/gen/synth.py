"""Synthetic RNA-seq samples with real ambiguity, made on the device.

The annotation (genes, isoforms, paralog families and their sequences) is a
property of the deployment: it is drawn once from the configuration's own
`annotation_seed`, as a real deployment quantifies every sample against one
annotation. Each distinct sample's expression profile and fragments (which
isoform, where, how long, which strand), and so its alignments, are drawn
from the traffic mix's `expression_seed`, so that every seed asks for the
same EM work; the bases its reads carry (sequencing errors, qualities) and
its unaligned pairs are drawn from the run's `--seed`, which also orders
the distinct samples in the window.

Structure, as the configuration and traffic files state it:

* Each gene has a core sequence; each isoform is a unique 5' segment, the
  core, and a unique 3' segment. A fragment that lies inside the core aligns,
  exactly, to every isoform of its gene at the shifted position; a fragment
  that touches a unique segment aligns to its own isoform only.
* A share of the genes form paralog families of a fixed size whose cores are
  copies of the family founder's core with a share of substituted bases. A
  core fragment of such a gene also aligns, with those mismatches, to every
  isoform of the other genes of its family. Isoforms per gene are capped so
  that no read has more than MAX_HITS alignments (RSEM's `bowtie -m 200`).
* Fragments are drawn by expression (lognormal TPM, sigma 1.5, one profile
  per distinct sample) times effective length; reads copy the fragment's
  ends with substitutions at the traffic's error rate and qualities
  uniform in [QUAL_LO, QUAL_HI].

Everything here is torch and numpy; nothing of the program under test is
imported, so the plain reference can read what this module makes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

MAX_HITS = 200  # RSEM's bowtie -m 200
QSIZE = 100  # quality alphabet of RSEM's tables
NCODES = 5  # A C G T N
QUAL_LO, QUAL_HI = 20, 40
CHUNK = 1 << 21  # reads per step of the read build
POS_CHUNK = 1 << 25  # reference positions per step of the sequence build


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed derived from `seed` (any whole number) and `keys`."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), *keys])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def lognormal_tpm(M: int, seed: int, sigma: float = 1.5) -> np.ndarray:
    """[M+1] TPM (entry 0 zero) drawn lognormal from a seed (a frozen copy of
    the port's `testing.lognormal_tpm`)."""
    rng = np.random.default_rng(seed)
    t = np.exp(rng.normal(0.0, sigma, M))
    return np.concatenate([[0.0], t / t.sum() * 1e6])


def _gen(device, seed: int) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


@dataclass
class Annotation:
    """Isoforms are 0-based here; the program's sid is isoform + 1."""

    gene_starts: np.ndarray  # [G+1] int64, 1-based sids (RSEM's .grp)
    iso_gene: np.ndarray  # [M] int64
    u5: np.ndarray  # [M] int64 unique 5' segment length
    u3: np.ndarray  # [M] int64
    core: np.ndarray  # [G] int64 core length
    tlen: np.ndarray  # [M] int64 transcript length
    fam_lo: np.ndarray  # [G] int64 first isoform of the gene's family
    fam_hi: np.ndarray  # [G] int64 one past its last isoform
    codes: np.ndarray  # [sum tlen] uint8, transcripts concatenated
    offsets: np.ndarray  # [M+1] int64 start of each isoform in codes

    @property
    def M(self) -> int:
        return len(self.iso_gene)

    @property
    def n_genes(self) -> int:
        return len(self.core)


def _isoform_counts(rng, G: int, M: int, cap: int, shape: float) -> np.ndarray:
    """Isoforms per gene: at least one, at most `cap`, summing to M; the
    extra isoforms fall on genes in proportion to Gamma(shape) weights."""
    if not G <= M <= G * cap:
        raise ValueError(f"{M} isoforms cannot fill {G} genes of 1..{cap}")
    w = rng.gamma(shape, 1.0, G)
    k = np.ones(G, dtype=np.int64)
    left = M - G
    while left > 0:
        room = k < cap
        p = np.where(room, w, 0.0)
        add = rng.multinomial(left, p / p.sum())
        k += np.minimum(add, cap - k)
        left = M - int(k.sum())
    return k


def make_annotation(cfg: Dict, traffic: Dict, device) -> Annotation:
    """The deployment's annotation: gene and isoform counts and the length
    constants from the configuration `cfg`, the core share and paralog
    families from the traffic mix, drawn from cfg["annotation_seed"]."""
    a = cfg["annotation"]
    G, M = int(cfg["genes"]), int(cfg["isoforms"])
    fam_size = int(traffic["paralog_family_size"])
    cap = min(int(a["max_isoforms_per_gene"]), MAX_HITS // max(fam_size, 1))
    rng = np.random.default_rng(sub_seed(cfg["annotation_seed"], 1))
    k = _isoform_counts(rng, G, M, cap, float(a["isoform_weight_shape"]))
    gene_starts = np.concatenate([[1], 1 + np.cumsum(k)]).astype(np.int64)
    iso_gene = np.repeat(np.arange(G), k)

    # paralog families: the first genes, in groups of fam_size
    n_fam = int(round(float(traffic["paralog_share"]) * G)) // fam_size
    founder = np.arange(G)
    if n_fam and fam_size > 1:
        founder[: n_fam * fam_size] = (np.arange(n_fam * fam_size)
                                       // fam_size) * fam_size
    first_gene = np.where(np.arange(G) < n_fam * fam_size, founder,
                          np.arange(G))
    last_gene = np.where(np.arange(G) < n_fam * fam_size,
                         founder + fam_size - 1, np.arange(G))
    fam_lo = gene_starts[first_gene] - 1
    fam_hi = gene_starts[last_gene + 1] - 1

    core = np.exp(rng.normal(np.log(a["core_median"]), a["core_sigma"], G))
    core = np.clip(core, a["core_min"], a["core_max"]).astype(np.int64)
    core = core[founder]  # a family shares its founder's core length
    s = float(traffic["core_share"])
    mean_u = core[iso_gene] * (1.0 - s) / (2.0 * s)
    u5 = np.maximum(1, (mean_u * rng.uniform(0.5, 1.5, M)).astype(np.int64))
    u3 = np.maximum(1, (mean_u * rng.uniform(0.5, 1.5, M)).astype(np.int64))
    tlen = u5 + core[iso_gene] + u3
    offsets = np.concatenate([[0], np.cumsum(tlen)]).astype(np.int64)

    codes = _sequences(device, sub_seed(cfg["annotation_seed"], 2), core,
                       founder, float(traffic["paralog_divergence"]),
                       iso_gene, u5, tlen, offsets)
    return Annotation(gene_starts, iso_gene, u5, u3, core, tlen, fam_lo,
                      fam_hi, codes, offsets)


def _sequences(device, seed, core, founder, divergence, iso_gene, u5, tlen,
               offsets) -> np.ndarray:
    """Concatenated transcript codes: unique segments random, cores random
    for founders and single genes, a paralog's core its founder's with
    `divergence` of its bases substituted."""
    g = _gen(device, seed)
    dev = torch.device(device)
    G = len(core)
    core_t = torch.as_tensor(core, device=dev)
    core_off = torch.zeros(G + 1, dtype=torch.int64, device=dev)
    core_off[1:] = torch.cumsum(core_t, 0)
    n_core = int(core_off[-1])
    pool = torch.randint(0, 4, (n_core,), generator=g, device=dev,
                         dtype=torch.uint8)
    cgene = torch.repeat_interleave(torch.arange(G, device=dev), core_t)
    local = torch.arange(n_core, device=dev) - core_off[cgene]
    fnd = torch.as_tensor(founder, device=dev)[cgene]
    base = pool[core_off[fnd] + local]
    mut = (torch.rand(n_core, generator=g, device=dev) < divergence) & (
        fnd != cgene)
    shift = torch.randint(1, 4, (n_core,), generator=g, device=dev,
                          dtype=torch.uint8)
    cores = torch.where(mut, (base + shift) % 4, base)
    del pool, cgene, local, fnd, base, mut, shift

    T = int(offsets[-1])
    unique = torch.randint(0, 4, (T,), generator=g, device=dev,
                           dtype=torch.uint8)
    off_t = torch.as_tensor(offsets, device=dev)
    u5_t = torch.as_tensor(u5, device=dev)
    cg = core_off[torch.as_tensor(iso_gene, device=dev)]
    clen = core_t[torch.as_tensor(iso_gene, device=dev)]
    tl_t = torch.as_tensor(tlen, device=dev)
    out = torch.empty(T, dtype=torch.uint8, device=dev)
    for a in range(0, T, POS_CHUNK):
        b = min(a + POS_CHUNK, T)
        p = torch.arange(a, b, device=dev)
        iso = torch.searchsorted(off_t, p, right=True) - 1
        t = p - off_t[iso] - u5_t[iso]
        in_core = (t >= 0) & (t < clen[iso])
        from_core = cores[(cg[iso] + t.clamp(min=0)).clamp(max=n_core - 1)]
        out[a:b] = torch.where(in_core, from_core, unique[a:b])
        del p, iso, t, in_core, from_core
    del tl_t
    return out.cpu().numpy()


@dataclass
class RawSample:
    """One parsed sample as ingest leaves it, in host numpy arrays: the N1
    aligned pairs' reads and alignments, and the streaming read statistics
    of every category (RSEM's 0 unaligned, 1 aligned, 2 filtered)."""

    codes1: np.ndarray  # [N1, L] uint8
    quals1: np.ndarray
    codes2: np.ndarray
    quals2: np.ndarray
    lens: np.ndarray  # [N1] int32
    rid: np.ndarray  # [H] int32
    sid: np.ndarray  # [H] int32, 1-based
    dir: np.ndarray  # [H] int8
    pos: np.ndarray  # [H] int32, strand-local
    ins: np.ndarray  # [H] int32 fragment length
    offsets: np.ndarray  # [N1+1] int64
    n0: int  # unaligned pairs
    stats: Dict[int, Dict[str, np.ndarray]]
    hist: Dict[int, int]  # alignments per read -> reads
    n_gene_multi: int  # reads aligned to more than one gene

    @property
    def n1(self) -> int:
        return len(self.lens)

    @property
    def n_hits(self) -> int:
        return len(self.sid)


def _empty_stats(L: int) -> Dict[str, np.ndarray]:
    return {"len_counts": np.zeros(max(L, 1024) + 1),
            "q_init": np.zeros(QSIZE), "q_tran": np.zeros((QSIZE, QSIZE)),
            "noise": np.zeros((QSIZE, NCODES)), "n_reads": 0}


def _add_stats(st, codes: torch.Tensor, quals: torch.Tensor, noise: bool):
    """ReadStats.add_reads for one mate of reads of one length (no read is
    of low quality at these lengths)."""
    n, L = codes.shape
    st["len_counts"][L] += n
    st["n_reads"] += n
    for a in range(0, n, CHUNK):
        q = quals[a:a + CHUNK].long()
        st["q_init"] += torch.bincount(q[:, 0], minlength=QSIZE).cpu().numpy()
        pair = (q[:, :-1] * QSIZE + q[:, 1:]).reshape(-1)
        st["q_tran"] += torch.bincount(pair, minlength=QSIZE * QSIZE).reshape(
            QSIZE, QSIZE).cpu().numpy()
        if noise:
            key = (q * NCODES + codes[a:a + CHUNK].long()).reshape(-1)
            st["noise"] += torch.bincount(
                key, minlength=QSIZE * NCODES).reshape(QSIZE, NCODES).cpu(
                ).numpy()


def make_sample(ann: Annotation, cfg: Dict, traffic: Dict, seed: int,
                index: int, device, pairs: Optional[int] = None
                ) -> RawSample:
    """Sample `index` of the run with `seed`: `pairs` read pairs (the
    traffic's pairs_per_sample unless given)."""
    dev = torch.device(device)
    L = int(traffic["read_length"])
    pairs = int(pairs if pairs is not None else traffic["pairs_per_sample"])
    n0 = int(round(pairs * float(traffic["unaligned_share"])))
    n1 = pairs - n0
    M = ann.M
    # sample `index`'s expression profile and fragments (isoform, start,
    # length, strand) are the traffic's own draw, so that every seed asks
    # for the same EM work; the seed draws the bases the reads carry (the
    # sequencing errors and qualities) and the unaligned pairs
    fixed = sub_seed(traffic["expression_seed"], 200 + index)
    gf = _gen(dev, fixed)
    g = _gen(dev, sub_seed(seed, 100 + index))
    tpm = lognormal_tpm(M, fixed)[1:]
    mean_f = float(traffic["fragment_mean"])
    eff = np.maximum(ann.tlen - mean_f + 1.0, 1.0)
    w = torch.as_tensor(tpm * eff, device=dev, dtype=torch.float64)
    cdf = torch.cumsum(w / w.sum(), 0)
    cdf[-1] = 1.0
    iso = torch.searchsorted(cdf, torch.rand(n1, generator=gf, device=dev,
                                             dtype=torch.float64))
    iso = iso.clamp(max=M - 1)

    tlen = torch.as_tensor(ann.tlen, device=dev)
    tl = tlen[iso]
    f = torch.round(mean_f + float(traffic["fragment_sd"]) * torch.randn(
        n1, generator=gf, device=dev, dtype=torch.float64)).long()
    f = torch.minimum(f.clamp(min=L), tl.clamp(max=int(cfg["max_fragment"])))
    # a fragment's start x, as a share of the positions it can start at,
    # has the density 1 + a (2x - 1): with a > 0, (1 + a) / (1 - a) times
    # as many starts at the 3' end as at the 5' end (inverse of its CDF)
    a = float(traffic.get("start_slope", 0.0))
    x = torch.rand(n1, generator=gf, device=dev, dtype=torch.float64)
    if a > 0:
        x = (torch.sqrt((1 - a) ** 2 + 4 * a * x) - (1 - a)) / (2 * a)
    s = (x * (tl - f + 1)).long()
    s = torch.minimum(s, tl - f)
    d = (torch.rand(n1, generator=gf, device=dev)
         >= float(cfg["forward_prob"])).to(torch.int64)

    # alignments: a core fragment to every isoform of its gene's family
    gene = torch.as_tensor(ann.iso_gene, device=dev)[iso]
    u5 = torch.as_tensor(ann.u5, device=dev)
    c0 = s - u5[iso]
    in_core = (c0 >= 0) & (c0 + f <= torch.as_tensor(ann.core,
                                                     device=dev)[gene])
    lo = torch.as_tensor(ann.fam_lo, device=dev)[gene]
    hi = torch.as_tensor(ann.fam_hi, device=dev)[gene]
    nh = torch.where(in_core, hi - lo, torch.ones_like(lo))
    offsets = torch.zeros(n1 + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(nh, 0)
    H = int(offsets[-1])
    hr = torch.repeat_interleave(torch.arange(n1, device=dev), nh,
                                 output_size=H)
    k = torch.arange(H, device=dev) - offsets[hr]
    hsid = torch.where(in_core[hr], lo[hr] + k, iso[hr])
    fwd = torch.where(in_core[hr], u5[hsid] + c0[hr], s[hr])
    hf = f[hr]
    hd = d[hr]
    hpos = torch.where(hd == 0, fwd, tlen[hsid] - fwd - hf)
    own_gene = torch.as_tensor(ann.gene_starts[1:] - ann.gene_starts[:-1],
                               device=dev)[gene]
    n_gene_multi = int((in_core & (hi - lo > own_gene)).sum())
    hist_t = torch.bincount(nh)
    hist = {int(v): int(c) for v, c in enumerate(hist_t.cpu().tolist()) if c}

    # reads: mate 1 leads on the fragment's strand, mate 2 is the other end
    ref = torch.as_tensor(ann.codes, device=dev)
    off = torch.as_tensor(ann.offsets, device=dev)
    err = float(traffic["error_rate"])
    j = torch.arange(L, device=dev)
    mates = []
    for mate in (1, 2):
        codes = torch.empty((n1, L), dtype=torch.uint8, device=dev)
        quals = torch.empty((n1, L), dtype=torch.uint8, device=dev)
        for a in range(0, n1, CHUNK):
            b = min(a + CHUNK, n1)
            sa, fa, da = s[a:b], f[a:b], d[a:b]
            tail = sa + fa - L
            fwd_mate = (da == 0) if mate == 1 else (da == 1)
            start = torch.where(fwd_mate, sa, tail)
            q = off[iso[a:b]][:, None] + start[:, None] + j[None, :]
            c = ref[q]
            rc = (3 - c).flip(1)
            c = torch.where(fwd_mate[:, None], c, rc)
            bad = torch.rand((b - a, L), generator=g, device=dev) < err
            shift = torch.randint(1, 4, (b - a, L), generator=g, device=dev,
                                  dtype=torch.uint8)
            codes[a:b] = torch.where(bad, (c + shift) % 4, c)
            quals[a:b] = torch.randint(QUAL_LO, QUAL_HI + 1, (b - a, L),
                                       generator=g, device=dev,
                                       dtype=torch.uint8)
        mates.append((codes, quals))

    stats = {cat: _empty_stats(L) for cat in range(3)}
    for codes, quals in mates:
        _add_stats(stats[1], codes, quals, noise=False)
    for _mate in (1, 2):  # unaligned pairs: random reads, noise statistics
        for a in range(0, n0, CHUNK):
            b = min(a + CHUNK, n0)
            codes = torch.randint(0, 4, (b - a, L), generator=g, device=dev,
                                  dtype=torch.uint8)
            quals = torch.randint(QUAL_LO, QUAL_HI + 1, (b - a, L),
                                  generator=g, device=dev, dtype=torch.uint8)
            _add_stats(stats[0], codes, quals, noise=True)

    def host(t, dt):
        return t.to(dt).cpu().numpy()

    return RawSample(
        codes1=host(mates[0][0], torch.uint8),
        quals1=host(mates[0][1], torch.uint8),
        codes2=host(mates[1][0], torch.uint8),
        quals2=host(mates[1][1], torch.uint8),
        lens=np.full(n1, L, dtype=np.int32),
        rid=host(hr, torch.int32), sid=host(hsid + 1, torch.int32),
        dir=host(hd, torch.int8), pos=host(hpos, torch.int32),
        ins=host(hf, torch.int32), offsets=host(offsets, torch.int64),
        n0=n0, stats=stats, hist=hist, n_gene_multi=n_gene_multi)
