"""Read simulator (reference: simulation.cpp + per-model simulate methods).

Counterpart of rsem_tpu/engine/simulate.py. Each chunk of reads is drawn on
the device: transcript, strand, fragment length (truncated inverse CDF),
start position (piecewise-linear RSPD inversion), quality strings (a Markov
chain over the read positions) and the bases of every read. Provenance is
encoded in read names as rid_dir_sid_pos[_insertL] like the reference
(PairedEndQModel.h:425-427), so round-trip evaluation works unchanged.

Each sampler is a draw and an inversion: the draw takes uniforms from one
`torch.Generator` on the device, the inversion is a plain function of those
uniforms and the model's tables (so tests can feed it the JAX package's
uniforms). Where the JAX package draws a categorical by Gumbel-argmax over
a broadcast [n, K] logit array, this module inverts a cumulative table:

* the transcript of each read: one f64 uniform per read searched in the f64
  cumulative theta (no [n, M+1] array; f64 keeps transcripts with a tiny
  theta reachable);
* quality codes, read bases and noise bases: rows of a categorical table are
  flattened into one sorted f64 vector whose row r holds r + the row's
  normalised cumulative sums, so the draw from row r with uniform u is one
  `searchsorted` of r + u. Zero entries are never drawn and an all-zero
  row is uniform, as in the JAX package's Gumbel draw over
  log(max(p, 1e-300)) (which gives a zero entry beside a positive one a
  probability below e^-600).

The fragment-length and RSPD inversions keep the JAX package's float32
arithmetic. Each chunk's records are assembled on the device as one byte
buffer (a gather of ACGTN, quality + 33, decimal digits of the name fields,
the bytes kept by a validity mask) and copied to the host once, byte-
identical to the JAX package's per-read formatting of the same arrays; the
host only writes it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..constants import EPSILON, NCODES, QSIZE
from ..model.generative import GenerativeModel
from ..utils.device import DeviceLike, resolve_device

# ------------------------------------------------------------------ #
# simulation-ready distribution tables (reference startSimulation)    #
# ------------------------------------------------------------------ #
def sim_profile_matrix(p: np.ndarray) -> np.ndarray:
    """Fix zero rows of a [K, 5, 5] profile for sampling
    (reference: Profile.h/QProfile.h startSimulation)."""
    out = p.copy()
    K = p.shape[0]
    N = NCODES - 1
    for i in range(K):
        row_tot = p[i].sum(axis=1)
        cp_sum = row_tot[:N].sum()
        if cp_sum == 0.0:
            continue
        cp_d = sum(p[i, j, j] for j in range(N))
        cp_n = p[i, :N, N].sum()
        p_d = cp_d / cp_sum
        p_n = cp_n / cp_sum
        p_o = (1.0 - p_d - p_n) / (NCODES - 2)
        for j in range(N):
            if row_tot[j] > 0.0:
                continue
            for k in range(NCODES):
                out[i, j, k] = p_d if k == j else (p_n if k == N else p_o)
        if row_tot[N] == 0.0:
            p_o2 = (1.0 - p_n) / (NCODES - 1)
            out[i, N, :N] = p_o2
            out[i, N, N] = p_n
    return out


def sim_noise_qprofile(p: np.ndarray) -> np.ndarray:
    """Zero rows -> uniform ACGT (reference: NoiseQProfile.h startSimulation)."""
    out = p.copy()
    zero = out.sum(axis=1) < 1e-300
    out[zero] = np.array([0.25, 0.25, 0.25, 0.25, 0.0])
    return out


def sim_theta(model: GenerativeModel, tpm: np.ndarray,
              theta0: float) -> np.ndarray:
    """[M+1] f64 read probabilities: theta_i ~ tpm_i * eel_i for i >= 1,
    scaled to 1 - theta0; theta_0 = theta0 (noise)."""
    eel = model.calc_eel()
    theta = np.zeros(len(eel))
    theta[1:] = tpm[1:] * eel[1:]
    denom = theta.sum()
    if not denom > EPSILON:
        raise ValueError("no transcript has a positive TPM x effective length")
    theta[0] = theta0
    theta[1:] = theta[1:] / denom * (1.0 - theta0)
    return theta


# ------------------------------------------------------------------ #
# inversions: plain functions of uniforms and tables                  #
# ------------------------------------------------------------------ #
def theta_cdf(theta: np.ndarray, device: torch.device
              ) -> Tuple[torch.Tensor, int]:
    """(f64 cumulative sums of max(theta, 0) on `device`, index of the last
    transcript with positive weight)."""
    w = np.maximum(np.asarray(theta, np.float64), 0.0)
    pos = np.flatnonzero(w > 0)
    if pos.size == 0:
        raise ValueError("theta has no positive entry")
    return torch.as_tensor(np.cumsum(w), device=device), int(pos[-1])


def transcript_invert(u: torch.Tensor, cum: torch.Tensor,
                      last: int) -> torch.Tensor:
    """Transcript ids [n] (int64) for f64 uniforms u in [0, 1): the first i
    with cum[i] > u * cum[-1]; zero-weight entries are never chosen."""
    t = u * cum[-1]
    return torch.searchsorted(cum, t, right=True).clamp_(max=last)


def row_table(p: np.ndarray) -> np.ndarray:
    """Flattened inversion table of the categorical rows p [R, K]: row r
    holds r + the cumulative sums of p[r] normalised to 1 (f64,
    non-decreasing, R * K entries); an all-zero row is uniform. A zero
    entry owns an empty interval, so no uniform, not even 0, draws it."""
    w = np.maximum(np.asarray(p, np.float64).reshape(-1, p.shape[-1]), 0.0)
    w[w.sum(axis=1) <= 0] = 1.0
    c = np.cumsum(w, axis=1)
    c /= c[:, -1:]
    c[:, -1] = 1.0
    return (c + np.arange(c.shape[0])[:, None]).reshape(-1)


def rows_invert(table: torch.Tensor, K: int, row: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Category in [0, K) drawn from row `row` of a `row_table` by the
    uniform u in [0, 1) (same shapes; int64 out)."""
    t = row.to(torch.float64) + u.to(torch.float64)
    k = torch.searchsorted(table, t.reshape(-1), right=True).view(t.shape)
    return (k - row * K).clamp_(0, K - 1)


def qual_invert(u: torch.Tensor, init_table: torch.Tensor,
                tran_table: torch.Tensor) -> torch.Tensor:
    """[n, L] quality codes of the first-order chain (QualDist) from
    uniforms u [L, n]: position 0 from p_init, position j from the
    transition row of position j - 1."""
    L, n = u.shape
    q = torch.empty((L, n), dtype=torch.int64, device=u.device)
    if L == 0:
        return q.T
    q[0] = rows_invert(init_table, QSIZE, torch.zeros_like(q[0]), u[0])
    for j in range(1, L):
        q[j] = rows_invert(tran_table, QSIZE, q[j - 1], u[j])
    return q.T


def lendist_invert(u: torch.Tensor, cdf: torch.Tensor, lb: int, ub: int,
                   refL: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """LenDist::simulate truncated at refL (refL = -1: the full support)
    for f32 uniforms u: (lengths [n] int64, ok [n])."""
    span = ub - lb
    dlen = (torch.where(refL < 0, ub, torch.clamp(refL, max=ub)) - lb
            ).clamp_(0, span)
    total = cdf[dlen]
    ok = (dlen > 0) & (total > 0.0)
    idx = torch.searchsorted(cdf, u * total, right=True)
    idx = torch.minimum(idx.clamp_(min=1), dlen.clamp(min=1))
    return lb + idx, ok


def rspd_invert(u: torch.Tensor, pdf: torch.Tensor, cdf: torch.Tensor,
                B: int, est: bool, effL: torch.Tensor,
                full_len: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """RSPD::simulate: start positions in [0, effL) for f32 uniforms u:
    (pos [n] int64, ok [n]). Rows with full_len = 0 (noise) get ok False."""
    if not est:
        pos = torch.floor(u * effL.to(torch.float32)).to(torch.int64)
        return torch.minimum(pos, effL - 1), effL > 0
    fl_i = full_len.clamp(min=1)
    fl = fl_i.to(torch.float32)
    i_eff = torch.div(effL * B, fl_i, rounding_mode="floor")
    val_eff = effL.to(torch.float32) / fl * B
    tot = cdf[i_eff] + (val_eff - i_eff.to(torch.float32)) * pdf[i_eff + 1]
    ok = (tot > 0.0) & (full_len > 0)
    t = u * tot
    bin_i = torch.searchsorted(cdf[1:B + 1].contiguous(), t,
                               right=True).clamp_(0, B - 1)
    pdf_b = torch.clamp(pdf[bin_i + 1], min=1e-30)
    val = bin_i.to(torch.float32) + (t - cdf[bin_i]) / pdf_b
    pos = torch.floor(val * fl / B).to(torch.int64)
    pos = torch.minimum(pos.clamp_(min=0), effL - 1)
    return pos, ok


# ------------------------------------------------------------------ #
# bulk FASTA/FASTQ records                                            #
# ------------------------------------------------------------------ #
def _bytes(b: bytes, device) -> torch.Tensor:
    return torch.tensor(list(b), dtype=torch.uint8, device=device)


def _const(b: bytes, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    mat = _bytes(b, device).expand(n, len(b))
    return mat, torch.ones((1, len(b)), dtype=torch.bool,
                           device=device).expand(n, len(b))


def name_fields(fields: List[torch.Tensor]
                ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (bytes, mask) blocks of `f0_f1_..._fk` for n rows of
    non-negative int64 fields: decimal digits right-aligned in [n, D], the
    mask marking the digits each value prints. Formatted once per chunk
    and shared by both mates."""
    n, dev = fields[0].shape[0], fields[0].device
    k = len(fields)
    ext = (torch.stack([f.max() for f in fields] + [f.min() for f in fields]
                       ).tolist() if n else [0] * (2 * k))
    if min(ext[k:]) < 0:
        raise ValueError("record name fields must be non-negative")
    blocks = []
    for f, m in zip(fields, ext[:k]):
        if blocks:
            blocks.append(_const(b"_", n, dev))
        D = len(str(m))
        pw = 10 ** torch.arange(D - 1, -1, -1, device=dev)
        v = f[:, None]
        nd = (v >= pw).sum(dim=1).clamp_(min=1)
        blocks.append(((v // pw % 10 + 48).to(torch.uint8),
                       torch.arange(D, device=dev) >= D - nd[:, None]))
    return blocks


def format_records(names, suffix: bytes, bases: torch.Tensor,
                   lens: torch.Tensor, quals: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    r"""FASTQ (quals given) or FASTA records of n reads as one uint8 buffer
    on the arrays' device: `@name<suffix>\n<bases>\n+\n<quals + 33>\n` or
    `>name<suffix>\n<bases>\n`, row r printing the first lens[r] of bases
    [n, L] (codes 0-4 of ACGTN) and quals [n, L]. `names` is
    `name_fields(...)` of the same n rows."""
    n, L = bases.shape
    dev = bases.device
    keep = torch.arange(L, device=dev)[None, :] < lens[:, None]
    blocks = [_const(b"@" if quals is not None else b">", n, dev), *names,
              _const(suffix + b"\n", n, dev),
              (_bytes(b"ACGTN", dev)[bases.long()], keep)]
    if quals is not None:
        blocks += [_const(b"\n+\n", n, dev), (quals + 33, keep)]
    blocks.append(_const(b"\n", n, dev))
    return torch.masked_select(torch.cat([b[0] for b in blocks], dim=1),
                               torch.cat([b[1] for b in blocks], dim=1))


# ------------------------------------------------------------------ #
# the device sampler                                                  #
# ------------------------------------------------------------------ #
class _Sampler:
    """The model's tables on the device and the draw of one chunk."""

    def __init__(self, model: GenerativeModel, ref, theta: np.ndarray,
                 dev: torch.device, gen: torch.Generator):
        spec = model.spec
        self.dev, self.gen = dev, gen
        self.paired, self.has_qual = spec.paired, spec.has_qual
        self.B, self.est = spec.B, spec.est_rspd
        self.probF = float(model.ori.prob[0])
        f32 = dict(dtype=torch.float32, device=dev)
        f64 = dict(dtype=torch.float64, device=dev)
        i64 = dict(dtype=torch.int64, device=dev)

        self.cum, self.last = theta_cdf(theta, dev)
        g = model.gld
        self.glb, self.gub = g.lb, g.ub
        self.gcdf = torch.as_tensor(g.device_arrays(g.lb, g.ub)[1], **f32)
        self.mld = model.mld
        if self.mld is not None:
            m = self.mld
            self.mlb, self.mub = m.lb, m.ub
            self.mcdf = torch.as_tensor(m.device_arrays(m.lb, m.ub)[1], **f32)
        self.rspd_pdf = torch.as_tensor(model.rspd.pdf, **f32)
        self.rspd_cdf = torch.as_tensor(model.rspd.cdf, **f32)
        self.tot_len = torch.as_tensor(ref.tot_len, **i64)
        self.full_len = torch.as_tensor(ref.full_len, **i64)
        self.codes = torch.as_tensor(np.asarray(ref.codes, np.uint8),
                                     device=dev)
        self.offsets = torch.as_tensor(ref.offsets, **i64)
        self.max_read = (self.mld.maxL if self.mld is not None
                         else g.maxL)

        # one table for every read base: the profile's rows (key x ref
        # base), then the noise rows (by quality, or one row)
        pro = sim_profile_matrix(model.pro.p)
        self.n_keys = pro.shape[0]
        if spec.has_qual:
            noise = sim_noise_qprofile(model.npro.p)
            self.qinit = torch.as_tensor(row_table(model.qd.p_init[None]),
                                         **f64)
            self.qtran = torch.as_tensor(row_table(model.qd.p_tran), **f64)
        else:
            noise = np.asarray(model.npro.p, np.float64)[None]
            if noise.sum() < 1e-300:
                noise = np.array([[0.25, 0.25, 0.25, 0.25, 0.0]])
        self.noise_row0 = pro.shape[0] * NCODES
        self.bases = torch.as_tensor(
            row_table(np.concatenate([pro.reshape(-1, NCODES), noise])),
            **f64)

    def _rand(self, *shape, dtype=torch.float32) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.dev,
                          dtype=dtype)

    def _ref_base(self, sid, pos, dirs, L: int) -> torch.Tensor:
        """[n, L] reference codes read from (sid, strand-local pos, dir);
        reverse-strand codes < 4 complemented."""
        j = torch.arange(L, device=self.dev)
        rev = (dirs == 1)[:, None]
        tl = self.tot_len[sid][:, None]
        start = self.offsets[sid][:, None] + torch.where(
            rev, tl - 1 - pos[:, None], pos[:, None])
        idx = (start + torch.where(rev, -j, j)).clamp_(
            0, self.codes.shape[0] - 1)
        c = self.codes[idx].to(torch.int64)
        return torch.where(rev & (c < 4), 3 - c, c)

    def _mate(self, sid, is_noise, frag, mpos, mdir):
        """(bases [n, L] uint8, quals [n, L] uint8 or None, lengths [n],
        ok [n]) of one mate."""
        n, L = sid.shape[0], self.max_read
        if self.mld is not None:
            mlen, ok = lendist_invert(
                self._rand(n), self.mcdf, self.mlb, self.mub,
                torch.where(is_noise, -1, frag))
        else:
            mlen, ok = frag, torch.ones_like(is_noise)
        quals = None
        if self.has_qual:
            quals = qual_invert(self._rand(L, n), self.qinit, self.qtran)
            key = quals
            noise_row = self.noise_row0 + quals
        else:
            key = torch.arange(L, device=self.dev).clamp_(
                max=self.n_keys - 1).expand(n, L)
            noise_row = torch.full_like(key, self.noise_row0)
        rb = self._ref_base(sid, mpos, mdir, L)
        row = torch.where(is_noise[:, None], noise_row, key * NCODES + rb)
        del rb, key, noise_row
        bases = rows_invert(self.bases, NCODES, row, self._rand(n, L))
        return (bases.to(torch.uint8),
                None if quals is None else quals.to(torch.uint8), mlen, ok)

    def chunk(self, n: int) -> dict:
        """Device arrays of n simulated reads; rows whose ok is False
        failed a truncated draw and are dropped by the caller."""
        sid = transcript_invert(self._rand(n, dtype=torch.float64),
                                self.cum, self.last)
        dirs = (self._rand(n) >= self.probF).to(torch.int64)
        tl = self.tot_len[sid]
        fl = self.full_len[sid]
        is_noise = sid == 0
        frag, ok_f = lendist_invert(self._rand(n), self.gcdf, self.glb,
                                    self.gub, torch.where(is_noise, -1, tl))
        effL = torch.minimum(fl, tl - frag + 1).clamp_(min=0)
        pos, ok_p = rspd_invert(self._rand(n), self.rspd_pdf, self.rspd_cdf,
                                self.B, self.est, effL, fl)
        pos = torch.where(dirs == 1, tl - pos - frag, pos)
        pos = torch.where(is_noise, 0, pos)
        ok = is_noise | (ok_f & ok_p)
        out = dict(sid=sid, dirs=dirs, pos=pos, frag=frag)
        b1, q1, l1, ok1 = self._mate(sid, is_noise, frag, pos, dirs)
        out.update(b1=b1, q1=q1, l1=l1)
        ok = ok & ok1
        if self.paired:
            m2pos = torch.where(is_noise, 0, tl - pos - frag)
            b2, q2, l2, ok2 = self._mate(sid, is_noise, frag, m2pos, 1 - dirs)
            out.update(b2=b2, q2=q2, l2=l2)
            ok = ok & ok2
        out["ok"] = ok
        return out


# ------------------------------------------------------------------ #
# entry point                                                         #
# ------------------------------------------------------------------ #
@dataclass
class SimResult:
    counts: np.ndarray  # [M+1] true counts (incl. noise at 0), f64
    n_resimulated: int
    # host-clock seconds, the device synchronised before each reading:
    sample_seconds: float = 0.0  # device draws
    assemble_seconds: float = 0.0  # records built on the device, copied out
    write_seconds: float = 0.0  # host file writes


def simulate_reads(
    model: GenerativeModel,
    ref,
    tpm: np.ndarray,  # [M+1] TPM column of an isoforms results file
    theta0: float,
    n_reads: int,
    out_prefix: str,
    seed: int = 0,
    chunk: int = 200_000,
    device: DeviceLike = None,
) -> SimResult:
    """Write out_prefix.fa/.fq (single) or _1/_2 mates (paired); returns the
    true counts for writeResultsSimulation. Runs on CUDA unless `device`
    says otherwise; draws come from one generator seeded with `seed`."""
    dev = resolve_device(device)
    spec = model.spec
    M = ref.M
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sampler = _Sampler(model, ref, sim_theta(model, tpm, theta0), dev, gen)

    counts = torch.zeros(M + 1, dtype=torch.int64, device=dev)
    n_resim, written = 0, 0
    secs = [0.0, 0.0, 0.0]  # sample, assemble, write
    mates = [("b1", "l1", "q1", b"/1" if spec.paired else b"")]
    if spec.paired:
        mates.append(("b2", "l2", "q2", b"/2"))
    ext = "fq" if spec.has_qual else "fa"
    files = [open(f"{out_prefix}{tag}.{ext}", "wb") for tag in
             (("_1", "_2") if spec.paired else ("",))]
    try:
        while written < n_reads:
            t0 = time.perf_counter()
            n = min(chunk, max(n_reads - written, 1024))
            out = sampler.chunk(n)
            ok = out.pop("ok")
            n_ok = int(ok.sum())  # waits for the chunk's draws
            t1 = time.perf_counter()
            take = min(n_ok, n_reads - written)
            n_resim += n - n_ok
            rows = torch.nonzero(ok).squeeze(1)[:take]
            sel = {k: None if v is None else v[rows] for k, v in out.items()}
            counts += torch.bincount(sel["sid"], minlength=M + 1)
            fields = [torch.arange(written, written + take, device=dev),
                      sel["dirs"], sel["sid"], sel["pos"]]
            if spec.paired:
                fields.append(sel["frag"])
            names = name_fields(fields)
            bufs = [format_records(names, suffix, sel[bk], sel[lk], sel[qk]
                                   ).cpu().numpy()
                    for bk, lk, qk, suffix in mates]
            t2 = time.perf_counter()
            for f, buf in zip(files, bufs):
                f.write(buf)
            written += take
            t3 = time.perf_counter()
            for i, dt in enumerate((t1 - t0, t2 - t1, t3 - t2)):
                secs[i] += dt
    finally:
        for f in files:
            f.close()
    return SimResult(counts=counts.cpu().numpy().astype(np.float64),
                     n_resimulated=n_resim, sample_seconds=secs[0],
                     assemble_seconds=secs[1], write_seconds=secs[2])
