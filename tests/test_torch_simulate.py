"""The port's read simulator (engine/simulate.py, device="cpu") against the
JAX package's: the simulation tables exactly, each inversion fed the JAX
package's own uniforms, the bulk record writer byte for byte against the
per-read loop, distributions of both simulators on the golden paired-end
model, the golden z-test against rsem-simulate-reads, and the
prepare -> simulate -> quantify round trip through the port's CLI."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rsem_tpu.engine import simulate as jsim
from rsem_tpu.model.generative import GenerativeModel as JaxModel
from rsem_tpu.refprep.reference import Reference as JaxReference
from rsem_tpu_torch.__main__ import main as port_main
from rsem_tpu_torch.engine import simulate as sim
from rsem_tpu_torch.model import GenerativeModel, LenDist, ModelSpec, RSPD
from rsem_tpu_torch.refprep.reference import Reference
from rsem_tpu_torch.testing import (
    counts_vs_theta,
    hist_vs_expected,
    provenance_sam,
    truncated_length_hist,
    two_sample_counts_ok,
)
from rsem_tpu_torch.utils.seq import decode

GOLD = os.path.join(os.path.dirname(__file__), "goldens")
CPU = torch.device("cpu")
N_DRAWS = 100_000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """In a test run of several worker processes torch's intra-op thread
    pool only adds contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(model_file, jax_side=False):
    cls_ref, cls_model = ((JaxReference, JaxModel) if jax_side
                          else (Reference, GenerativeModel))
    refs = cls_ref.load_seq(f"{GOLD}/ref.seq")
    return refs, cls_model.read(f"{GOLD}/{model_file}", refs=refs)


def _golden_tpm(M):
    rows = [l.rstrip("\n").split("\t")
            for l in open(f"{GOLD}/golden.isoforms.results")]
    tpm = np.zeros(M + 1)
    tpm[1:] = [float(r[rows[0].index("TPM")]) for r in rows[1:]]
    return tpm


# ------------------------------------------------------------------ #
# tables and inversions                                               #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("model_file", ["golden.model", "golden_pe.model",
                                        "golden_se0.model",
                                        "golden_pe2.model"])
def test_sim_tables_equal_jax(model_file):
    _refs, model = _golden(model_file)
    np.testing.assert_array_equal(sim.sim_profile_matrix(model.pro.p),
                                  jsim.sim_profile_matrix(model.pro.p))
    if model.spec.has_qual:
        np.testing.assert_array_equal(sim.sim_noise_qprofile(model.npro.p),
                                      jsim.sim_noise_qprofile(model.npro.p))


def test_sim_tables_fix_zero_rows_like_jax():
    rng = np.random.default_rng(5)
    p = rng.random((6, 5, 5))
    p[1] = 0.0  # an all-zero key
    p[2, 0] = 0.0  # one zero ref-base row
    p[3, 4] = 0.0  # zero N row
    p[4, :4] = 0.0  # only N observed
    got, want = sim.sim_profile_matrix(p), jsim.sim_profile_matrix(p)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, p)
    q = rng.random((100, 5))
    q[[0, 7, 99]] = 0.0
    np.testing.assert_array_equal(sim.sim_noise_qprofile(q),
                                  jsim.sim_noise_qprofile(q))


def _agree(got, want, what):
    """>= 99.99% equal, the rest off by one (a CDF step)."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(
        np.int64)
    diff = np.abs(got - want)
    assert (diff == 0).mean() >= 0.9999, (what, (diff != 0).sum())
    assert diff.max() <= 1, what


@pytest.mark.parametrize("which", ["gld_se", "gld_pe", "mld_pe",
                                   "normal"])
def test_lendist_inversion_matches_jax(which):
    if which == "normal":
        ld = LenDist(1, 1000)
        ld.set_as_normal(210.0, 60.0, 1, 1000)
    else:
        _refs, model = _golden("golden.model" if which == "gld_se"
                               else "golden_pe.model")
        ld = model.mld if which == "mld_pe" else model.gld
    pdf, cdf = ld.device_arrays(ld.lb, ld.ub)
    rng = np.random.default_rng(11)
    refL = rng.integers(0, ld.ub + 60, size=N_DRAWS)
    refL[rng.random(N_DRAWS) < 0.2] = -1  # noise rows: the full support
    refL[:50] = np.arange(ld.lb - 10, ld.lb + 40)  # around the lower bound
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, refL.shape, dtype=jnp.float32))
    want_len, want_ok = jsim._lendist_sample(
        key, jnp.asarray(pdf, jnp.float32), jnp.asarray(cdf, jnp.float32),
        ld.lb, ld.ub, jnp.asarray(refL, jnp.int32))
    got_len, got_ok = sim.lendist_invert(
        torch.tensor(u), torch.as_tensor(cdf, dtype=torch.float32),
        ld.lb, ld.ub, torch.from_numpy(refL))
    _agree(got_ok.numpy(), np.asarray(want_ok), "ok")
    ok = np.asarray(want_ok)
    assert ok.mean() > 0.3
    _agree(got_len.numpy()[ok], np.asarray(want_len)[ok], "length")


@pytest.mark.parametrize("est", ["golden_pe", "random", False])
def test_rspd_inversion_matches_jax(est):
    if est == "golden_pe":
        rspd = _golden("golden_pe.model")[1].rspd
        assert rspd.est_rspd
    elif est == "random":
        rspd = RSPD(True, 20)
        rspd.set_pdf(np.random.default_rng(2).random(20) ** 3)
    else:
        rspd = RSPD(False)
    rng = np.random.default_rng(12)
    full = rng.integers(30, 3000, size=N_DRAWS)
    effL = np.minimum(full, rng.integers(0, 3100, size=N_DRAWS))
    effL[:100] = full[:100]  # the whole transcript
    effL[100:200] = 0
    key = jax.random.PRNGKey(4)
    u = np.asarray(jax.random.uniform(key, effL.shape, dtype=jnp.float32))
    want_pos, want_ok = jsim._rspd_sample(
        key, jnp.asarray(rspd.pdf, jnp.float32),
        jnp.asarray(rspd.cdf, jnp.float32), rspd.B, bool(est),
        jnp.asarray(effL, jnp.int32), jnp.asarray(full, jnp.int32))
    got_pos, got_ok = sim.rspd_invert(
        torch.tensor(u), torch.as_tensor(rspd.pdf, dtype=torch.float32),
        torch.as_tensor(rspd.cdf, dtype=torch.float32), rspd.B, bool(est),
        torch.from_numpy(effL), torch.from_numpy(full))
    _agree(got_ok.numpy(), np.asarray(want_ok), "ok")
    ok = np.asarray(want_ok)
    assert ok.mean() > 0.9
    got_pos = got_pos.numpy()
    _agree(got_pos[ok], np.asarray(want_pos)[ok], "pos")
    assert ((got_pos[ok] >= 0) & (got_pos[ok] < effL[ok])).all()


def test_transcript_inversion():
    """Inverse CDF over the f64 cumulative theta: equal to numpy's, zero
    weights never drawn, a weight of 1e-12 still drawn at its rate."""
    refs, model = _golden("golden.model")
    theta = sim.sim_theta(model, _golden_tpm(refs.M), 0.05)
    theta[[3, 9, refs.M]] = 0.0
    theta[5] = 1e-12
    cum, last = sim.theta_cdf(theta, CPU)
    assert last == refs.M - 1
    u = np.random.default_rng(0).random(N_DRAWS)
    u[:4] = [0.0, 1.0 - 2 ** -53, 0.5, theta[0] / theta.sum()]
    got = sim.transcript_invert(torch.from_numpy(u), cum, last).numpy()
    c = np.cumsum(np.maximum(theta, 0))
    want = np.minimum(np.searchsorted(c, u * c[-1], side="right"), last)
    np.testing.assert_array_equal(got, want)
    assert not np.isin(got, [3, 9, refs.M]).any()
    # the tiny entry owns the f64 interval (cum[4], cum[5]]
    lo = c[4] / c[-1]
    probe = torch.tensor([np.nextafter(lo, 1.0)], dtype=torch.float64)
    assert int(sim.transcript_invert(probe, cum, last)) == 5


def _cdf(p):
    """Per-row normalised cumulative sums; an all-zero row is uniform."""
    w = np.where(p.sum(axis=-1, keepdims=True) > 0, p, 1.0)
    c = np.cumsum(w, axis=-1) / w.sum(axis=-1, keepdims=True)
    c[..., -1] = 1.0
    return c


def test_rows_and_quality_chain_inversions():
    """The flattened row tables against a per-row inverse CDF: bases, a
    zero row (uniform), zero entries never drawn, not even by u = 0 (which
    torch.rand returns once in 2^24 draws), and the quality chain step by
    step."""
    rng = np.random.default_rng(8)
    p = rng.random((7, 5)) ** 4
    p[2] = 0.0
    p[4, 1] = 0.0
    p[5, :2] = 0.0
    table = torch.from_numpy(sim.row_table(p))
    row = rng.integers(0, 7, size=N_DRAWS)
    u = rng.random(N_DRAWS).astype(np.float32)
    u[:1000] = 0.0
    got = sim.rows_invert(table, 5, torch.from_numpy(row),
                          torch.from_numpy(u)).numpy()
    c = _cdf(p)
    want = np.where(u[:, None] < c[row], np.arange(5), 5).min(axis=1)
    np.testing.assert_array_equal(got, want)
    assert not (got[row == 4] == 1).any()
    assert not (got[row == 5] < 2).any()
    assert (got[:1000][row[:1000] == 5] == 2).all()
    np.testing.assert_allclose(np.bincount(got[row == 2], minlength=5)
                               / (row == 2).sum(), 0.2, atol=0.02)

    _refs, model = _golden("golden_pe.model")
    qd = model.qd
    L, n = 40, 5000
    uq = rng.random((L, n)).astype(np.float32)
    uq[:, :10] = 0.0
    got_q = sim.qual_invert(
        torch.from_numpy(uq),
        torch.from_numpy(sim.row_table(qd.p_init[None])),
        torch.from_numpy(sim.row_table(qd.p_tran))).numpy()
    assert got_q.shape == (n, L)

    def first_above(u, c):
        return np.where(u[:, None] < c, np.arange(c.shape[-1]),
                        c.shape[-1]).min(axis=1)

    q = first_above(uq[0], _cdf(qd.p_init)[None])
    np.testing.assert_array_equal(got_q[:, 0], q)
    ct = _cdf(qd.p_tran)
    for j in range(1, L):
        q = first_above(uq[j], ct[q])
        np.testing.assert_array_equal(got_q[:, j], q)
    # the chain stays on the qualities the model has seen
    seen = np.flatnonzero(qd.p_init + qd.p_tran.sum(axis=0))
    assert np.isin(got_q, seen).all()


# ------------------------------------------------------------------ #
# bulk records                                                        #
# ------------------------------------------------------------------ #
def _loop_records(names, suffix, bases, lens, quals):
    """The JAX package's per-read formatting (simulate.py's write loop)."""
    id2char = np.frombuffer(b"ACGTN", dtype=np.uint8)
    out = []
    for r in range(len(names)):
        L = int(lens[r])
        seqs = id2char[bases[r, :L]].tobytes().decode()
        if quals is not None:
            qs = (quals[r, :L] + 33).astype(np.uint8).tobytes().decode()
            out.append(f"@{names[r]}{suffix}\n{seqs}\n+\n{qs}\n")
        else:
            out.append(f">{names[r]}{suffix}\n{seqs}\n")
    return "".join(out).encode()


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("has_qual", [False, True])
def test_bulk_records_equal_the_read_loop(paired, has_qual):
    rng = np.random.default_rng(int(paired) * 2 + int(has_qual))
    for n, L in ((0, 5), (1, 1), (3000, 60)):
        written = int(rng.integers(0, 10 ** 7))
        fields = [np.arange(written, written + n),
                  rng.integers(0, 2, size=n), rng.integers(0, 12345, size=n),
                  rng.integers(0, 10 ** rng.integers(1, 7, size=n))]
        fields[3][: min(n, 2)] = 0
        if paired:
            fields.append(rng.integers(1, 700, size=n))
        bases = rng.integers(0, 5, size=(n, L)).astype(np.uint8)
        lens = rng.integers(0, L + 1, size=n)
        quals = (rng.integers(0, 94, size=(n, L)).astype(np.uint8)
                 if has_qual else None)
        names = ["_".join(str(int(f[r])) for f in fields) for r in range(n)]
        t = torch.from_numpy
        blocks = sim.name_fields([t(f) for f in fields])
        for suffix in ((b"/1", b"/2") if paired else (b"",)):
            got = sim.format_records(blocks, suffix, t(bases), t(lens),
                                     None if quals is None else t(quals))
            assert got.dtype == torch.uint8
            assert got.numpy().tobytes() == _loop_records(
                names, suffix.decode(), bases, lens, quals)


# ------------------------------------------------------------------ #
# the simulator                                                       #
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def sim_model():
    """The hand-built model of tests/test_simulate.py, in the port."""
    rng = np.random.default_rng(42)
    seqs = [decode(rng.integers(0, 4, size=l)) for l in (400, 300, 250)]
    ref = Reference(["t1", "t2", "t3"], seqs, [0, 0, 0])
    model = GenerativeModel(ModelSpec(model_type=1, seed_len=25), ref)
    ld = LenDist(1, 1000)
    ld.init()
    ld.update(np.array([50]), np.array([1.0]))
    ld.finish()
    model.gld = ld
    model.qd.update_counts(
        np.eye(100)[30] * 10, np.outer(np.eye(100)[30], np.eye(100)[30]) * 10
    )
    model.qd.finish()
    model.npro.calc_init_params()
    model.freeze_windows()
    model.calc_mw()
    return ref, model


def test_simulate_distribution(sim_model, tmp_path):
    """tests/test_simulate.py::test_simulate_distribution on the port."""
    ref, model = sim_model
    tpm = np.array([0.0, 500_000.0, 300_000.0, 200_000.0])
    res = sim.simulate_reads(
        model, ref, tpm, theta0=0.05, n_reads=20_000,
        out_prefix=str(tmp_path / "sim"), seed=3, chunk=20_000, device="cpu",
    )
    assert res.counts.dtype == np.float64 and res.counts.shape == (4,)
    assert res.counts.sum() == 20_000
    eel = model.calc_eel()
    expect = tpm * eel
    expect = expect[1:] / expect[1:].sum() * 0.95 * 20_000
    np.testing.assert_allclose(res.counts[1:], expect, rtol=0.08)
    assert res.counts[0] == pytest.approx(1000, rel=0.2)

    lines = (tmp_path / "sim.fq").read_text().splitlines()
    assert len(lines) == 4 * 20_000
    rid, d, sid, pos = (int(x) for x in lines[0][1:].split("_"))
    assert rid == 0 and 0 <= sid <= 3 and d in (0, 1)
    assert len(lines[1]) == 50 and len(lines[3]) == 50
    assert lines[3][0] == chr(30 + 33)  # quality 30
    rids = [int(l[1:].split("_")[0]) for l in lines[::4]]
    assert rids == list(range(20_000))


def _read_fastq(path):
    with open(path) as f:
        lines = f.read().splitlines()
    names = [l[1:] for l in lines[0::4]]
    return names, lines[1::4], lines[3::4]


def _mate_stats(refs, names, seqs, quals, mate):
    """(per-position mismatch rate against the reference, per-position
    mean and variance of quality, their counts) of one mate's reads."""
    f = np.array([[int(x) for x in n.split("/")[0].split("_")]
                  for n in names])
    sid, d, pos = f[:, 2], f[:, 1], f[:, 3]
    keep = sid > 0
    tl = refs.tot_len[sid]
    if mate == 2:
        pos, d = tl - pos - f[:, 4], 1 - d
    L = max(len(s) for s in seqs)
    lens = np.array([len(s) for s in seqs])
    j = np.arange(L)[None, :]
    valid = (j < lens[:, None]) & keep[:, None]
    rd = np.zeros((len(seqs), L), np.int64)
    qv = np.zeros((len(seqs), L))
    lut = np.full(256, 4, np.int64)
    lut[np.frombuffer(b"ACGTN", np.uint8)] = np.arange(5)
    for r, (s, q) in enumerate(zip(seqs, quals)):
        rd[r, :len(s)] = lut[np.frombuffer(s.encode(), np.uint8)]
        qv[r, :len(q)] = np.frombuffer(q.encode(), np.uint8) - 33.0
    off = refs.offsets[sid][:, None]
    idx = np.where(d[:, None] == 1, off + tl[:, None] - 1 - pos[:, None] - j,
                   off + pos[:, None] + j)
    c = refs.codes[np.clip(idx, 0, len(refs.codes) - 1)].astype(np.int64)
    c = np.where((d[:, None] == 1) & (c < 4), 3 - c, c)
    n = valid.sum(axis=0)
    mis = ((rd != c) & valid).sum(axis=0) / n
    qa = np.where(valid, qv, 0).sum(axis=0) / n
    qvar = np.where(valid, (qv - qa) ** 2, 0).sum(axis=0) / n
    return mis, qa, qvar, n


def _hist_close(a, b, what):
    """Two histograms of samples of one distribution: every bin within
    5 sd of the difference + 3."""
    k = max(len(a), len(b))
    a, b = np.pad(a, (0, k - len(a))), np.pad(b, (0, k - len(b)))
    bad = np.abs(a - b) > 5 * np.sqrt(a + b) + 3
    assert not bad.any(), (what, np.nonzero(bad))


def test_port_matches_jax_simulator_on_golden_pe(tmp_path):
    n = 50_000
    refs, model = _golden("golden_pe.model")
    jrefs, jmodel = _golden("golden_pe.model", jax_side=True)
    # the golden profile is error-free: give both models the same
    # quality-keyed error rates 10^(-q/20), so mismatches are drawn
    err = np.minimum(10.0 ** (-np.arange(100) / 20.0), 0.3)[:, None, None]
    eye = np.eye(5)[None, :4]
    model.pro.p[:, :4] = (1 - err) * eye + err / 4 * (1 - eye)
    jmodel.pro.p = model.pro.p.copy()
    tpm = _golden_tpm(refs.M)
    mine = sim.simulate_reads(model, refs, tpm, 0.05, n,
                              str(tmp_path / "port"), seed=21, device="cpu")
    theirs = jsim.simulate_reads(jmodel, jrefs, tpm, 0.05, n,
                                 str(tmp_path / "jax"), seed=21)
    a, b = mine.counts, theirs.counts
    assert a.sum() == b.sum() == n
    assert two_sample_counts_ok(a, b, n).all()

    stats = {}
    for side in ("port", "jax"):
        s1 = _read_fastq(str(tmp_path / f"{side}_1.fq"))
        s2 = _read_fastq(str(tmp_path / f"{side}_2.fq"))
        assert len(s1[0]) == len(s2[0]) == n
        assert [x[:-2] for x in s1[0]] == [x[:-2] for x in s2[0]]
        f = np.array([[int(x) for x in name[:-2].split("_")]
                      for name in s1[0]])
        mlen = np.array([len(x) for x in s1[1] + s2[1]])
        stats[side] = dict(
            frag=np.bincount(f[:, 4]), mlen=np.bincount(mlen),
            m1=_mate_stats(refs, *s1, mate=1),
            m2=_mate_stats(refs, *s2, mate=2))
        if side == "port":
            frag_by_read = np.where(f[:, 2] == 0, -1, f[:, 4])
    mp, mj = stats["port"], stats["jax"]
    _hist_close(mp["frag"], mj["frag"], "fragment length")
    _hist_close(mp["mlen"], mj["mlen"], "mate length")
    # the port's draws against the model itself: transcripts against
    # theta, fragment lengths against gld truncated at each transcript,
    # mate lengths against mld truncated at each fragment
    worst, p_chi2 = counts_vs_theta(a, sim.sim_theta(model, tpm, 0.05), n)
    assert worst <= 1.0 and p_chi2 > 1e-6
    refL = np.where(np.arange(refs.M + 1) == 0, -1, refs.tot_len)
    assert hist_vs_expected(mp["frag"], truncated_length_hist(
        model.gld, refL, a)) <= 1.0
    fr, fc = np.unique(frag_by_read, return_counts=True)
    assert hist_vs_expected(mp["mlen"], truncated_length_hist(
        model.mld, fr, 2 * fc)) <= 1.0
    assert mp["frag"].nonzero()[0].min() >= model.gld.minL
    assert mp["mlen"].nonzero()[0].max() <= model.mld.maxL
    for m in ("m1", "m2"):
        (mis_a, qa_a, qv_a, n_a), (mis_b, qa_b, qv_b, n_b) = mp[m], mj[m]
        pb = (mis_a * n_a + mis_b * n_b) / (n_a + n_b)
        tol = 5 * np.sqrt(pb * (1 - pb) * (1 / n_a + 1 / n_b)) + 1e-3
        assert (np.abs(mis_a - mis_b) <= tol).all(), m
        assert 0.01 < mis_a.mean() < 0.1
        tol = 5 * np.sqrt(qv_a / n_a + qv_b / n_b) + 0.05
        assert (np.abs(qa_a - qa_b) <= tol).all(), m


def _counts_of(path, col):
    rows = [l.rstrip("\n").split("\t") for l in open(path)]
    return {r[0]: float(r[rows[0].index(col)]) for r in rows[1:]}


def test_round_trip_through_the_cli(tmp_path, monkeypatch):
    """prepare-reference -> simulate-reads (golden model, 100k reads, seed
    7) -> the binomial z-test against rsem-simulate-reads' counts
    (tests/test_parity_extra.py:315-346) -> calculate-expression on the
    provenance SAM: expected counts equal the simulator's truth."""
    monkeypatch.chdir(tmp_path)
    n = 100_000
    assert port_main(["prepare-reference", "--transcript-to-gene-map",
                      f"{GOLD}/map.txt", f"{GOLD}/tx.fa", "ref", "-q"]) == 0
    assert port_main(["simulate-reads", "ref", f"{GOLD}/golden.model",
                      f"{GOLD}/golden.isoforms.results", "0.05", str(n),
                      "sim", "--seed", "7", "--device", "cpu", "-q"]) == 0
    refs = Reference.load_seq("ref.seq")
    truth = _counts_of("sim.sim.isoforms.results", "count")
    tids = refs.names[1:]
    mine = np.array([n - sum(truth.values())] + [truth[t] for t in tids])
    gold_t = _counts_of(f"{GOLD}/golden_sim.isoforms.results", "count")
    gold = np.array([0.0] + [gold_t[t] for t in tids])
    gold[0] = n - gold.sum()
    assert two_sample_counts_ok(mine, gold, n).all()

    prov = provenance_sam(refs, "sim.fq", "simaln.sam")
    np.testing.assert_array_equal(prov, mine)
    assert port_main(["calculate-expression", "--alignments", "simaln.sam",
                      "ref", "ours", "-q", "--device", "cpu"]) == 0
    got = _counts_of("ours.isoforms.results", "expected_count")
    for k, tid in enumerate(tids, start=1):
        assert got[tid] == pytest.approx(prov[k], abs=1e-2)


def test_same_seed_same_bytes_and_chunks(tmp_path):
    refs, model = _golden("golden_pe.model")
    tpm = _golden_tpm(refs.M)

    def run(tag, seed, chunk):
        res = sim.simulate_reads(model, refs, tpm, 0.05, 3000,
                                 str(tmp_path / tag), seed=seed, chunk=chunk,
                                 device="cpu")
        return res, [(tmp_path / f"{tag}_{m}.fq").read_bytes()
                     for m in (1, 2)]

    r1, a = run("a", 3, 1024)
    r2, b = run("b", 3, 1024)
    _r3, c = run("c", 4, 1024)
    assert a == b and a != c
    np.testing.assert_array_equal(r1.counts, r2.counts)
    # 3 chunks of 1024 reads: record ids run on across chunks
    names = _read_fastq(str(tmp_path / "a_1.fq"))[0]
    assert [int(x.split("_")[0]) for x in names] == list(range(3000))


def test_simulate_reads_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this check is about machines without CUDA")
    refs, model = _golden("golden.model")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sim.simulate_reads(model, refs, _golden_tpm(refs.M), 0.05, 10,
                           str(tmp_path / "x"))
    for name in ("seq", "ti", "grp"):
        shutil.copy(f"{GOLD}/ref.{name}", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["simulate-reads", str(tmp_path / "ref"),
                   f"{GOLD}/golden.model", f"{GOLD}/golden.isoforms.results",
                   "0.05", "10", str(tmp_path / "y")])
    assert not (tmp_path / "x.fq").exists()
