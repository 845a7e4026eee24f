"""The port's multiple-device paths (rsem_tpu_torch.parallel and the `dist`
arguments of run_em, run_gibbs, run_ci and the driver) on the CPU.

In process: the read partitions and the rank slices against the JAX
package's, K1 split around the sum over ranks, K5 keyed on the global
chain, and the entry's refusal to go on alone. Then one two-process gloo
group (this file run as a script, once per rank, formed by the real
`maybe_initialize` on 127.0.0.1) runs every sharded case once and saves
what it got; the tests hold that against the same calls in this process
without a group (world 1) and against the JAX package's run_em on its
8-device CPU mesh, which two more processes run (this file again, one per
EM case) beside the ranks. All four start before the first test and run
while the in-process tests do.

Tolerances: EM counts within rtol 1e-5 of world 1 and the round count
within 2 (the f64 sums run in another order); Gibbs count vectors and CI
columns identical on shared inputs (frozen conprbs, count vectors); the
driver's tables at the golden tolerances of tests/test_torch_ci.py and
tests/test_torch_gibbs.py; against the JAX package, those of
tests/test_torch_em.py::test_converged_run.
"""

import copy
import os
import pickle
import random
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rsem_tpu_torch import convert
from rsem_tpu_torch.engine import em as tem
from rsem_tpu_torch.engine.ci import CIConfig, run_ci
from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
from rsem_tpu_torch.ops import conprb, gibbs, theta
from rsem_tpu_torch.parallel import distributed, fast_sharded, mesh
from rsem_tpu_torch.refprep.transcripts import GroupInfo
from rsem_tpu_torch.testing import synthetic_gibbs_hits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(ROOT, "tests", "goldens")
WORLD = 2
RANK_TIMEOUT = 120  # seconds a rank may take: a hang fails, not stalls
DATASETS = {  # the JAX package's synthetic_dataset arguments
    "se": dict(n_reads=3000, M=200, read_len=36, tx_len=400, paired=False,
               has_qual=True, mean_extra_hits=1.2, seed=7),
    "pe": dict(n_reads=2000, M=200, read_len=36, tx_len=400, paired=True,
               has_qual=True, mean_extra_hits=1.2, seed=8),
}
DRIVER_ARGS = ["--calc-pme", "--calc-ci", "--seed", "1234",
               "--gibbs-burnin", "50", "--gibbs-number-of-samples", "320",
               "--no-bam-output", "-q", "--device", "cpu"]


# ------------------------------------------------------------------ #
# the sharded cases, run alike by each rank and by world 1 here       #
# ------------------------------------------------------------------ #
def _em_result(res) -> dict:
    return {"counts": res.counts, "theta": res.theta_raw, "tpm": res.tpm,
            "rounds": res.rounds, "windows": getattr(res, "windows", 1),
            "frac_hit": res.frac_hit, "frac_noise": res.frac_noise,
            "log_conprb": res.log_conprb, "pro": res.model.pro.p,
            "npro": res.model.npro.p,
            "gld": res.model.gld.pdf if res.model.spec.paired else None}


def case_em_fused(inputs, dist):
    """Single end, the fused model loop (the default)."""
    ref, bundle, model = inputs["se"]
    res = tem.run_em(copy.deepcopy(model), ref, bundle, tem.EMConfig(),
                     need_posteriors=True, device="cpu", dist=dist)
    return _em_result(res)


def case_em_windowed(inputs, dist):
    """Paired end, PreIdx windows forced by the budget: a third of the
    whole PreIdx, so world 1 and each rank both cut windows."""
    ref, bundle, model = inputs["pe"]
    kcfg = tem.kernel_config(model, bundle,
                             int(bundle.reads.mate1.codes.shape[1]))
    budget = conprb.preidx_bytes(kcfg, bundle.hits.n_hits,
                                 bundle.hits.n_reads) // 3
    res = tem.run_em(copy.deepcopy(model), ref, bundle,
                     tem.EMConfig(preidx_budget=budget),
                     need_posteriors=True, device="cpu", dist=dist)
    return _em_result(res)


def _gibbs_inputs():
    """Frozen conprbs shared by both runs (not each run's own EM: the
    sum's order moves a refit's last bits, and a chain can then branch)."""
    M = 120
    hits, lcp, lnp = synthetic_gibbs_hits(3000, M, seed=4, max_hits=6)
    gi = GroupInfo(np.concatenate([np.arange(1, M + 1, 3), [M + 1]]))
    return hits, lcp, lnp, M, gi


def case_gibbs(inputs, dist):
    hits, lcp, lnp, M, gi = _gibbs_inputs()
    cfg = GibbsConfig(burnin=10, nsamples=40, n_chains=4, seed=3)
    res = run_gibbs(hits, lcp, lnp, M, 5, np.full(M + 1, 300.0),
                    np.ones(M + 1), gi, cfg, device="cpu", dist=dist)
    return {"countvectors": res.countvectors.numpy(), "pme_c": res.pme_c,
            "pve_c_genes": res.pve_c_genes}


def _ci_inputs():
    """Count vectors, alleles in transcripts (ta) in genes (gi) of
    uneven sizes, so the column cuts must respect both groupings."""
    rng = np.random.default_rng(11)
    t_sizes = rng.integers(1, 3, 150)  # alleles per transcript
    M = int(t_sizes.sum())
    ta = GroupInfo(np.concatenate([[1], 1 + np.cumsum(t_sizes)]))
    g_cuts = np.concatenate([[0], np.cumsum(rng.integers(1, 4, 80))])
    g_cuts = g_cuts[g_cuts < ta.m]
    gi = GroupInfo(np.concatenate([ta.starts[g_cuts], [M + 1]]))
    cvs = rng.poisson(rng.gamma(2.0, 20.0, M + 1), (120, M + 1))
    eel = rng.uniform(50, 500, M + 1)
    return cvs.astype(np.float32), eel, np.ones(M + 1), gi, ta


def case_ci(inputs, dist):
    cvs, eel, mw, gi, ta = _ci_inputs()
    res = run_ci(cvs, eel, mw, gi, CIConfig(nspc=20, seed=5), device="cpu",
                 ta=ta, dist=dist)
    return {f"{lvl}.{f}": getattr(getattr(res, lvl), f)
            for lvl in ("tpm", "fpkm", "gene_tpm", "gene_fpkm", "iso_tpm",
                        "iso_fpkm") for f in ("lb", "ub", "cqv")}


def _golden_inputs(d):
    for f in ("ref.seq", "ref.ti", "ref.grp"):
        shutil.copy(os.path.join(GOLD, f), d)
    import gzip

    with gzip.open(os.path.join(GOLD, "aln.sam.gz"), "rb") as fi, \
            open(os.path.join(d, "in.sam"), "wb") as fo:
        shutil.copyfileobj(fi, fo)


def case_driver(inputs, dist):
    """calculate-expression --calc-pme --calc-ci on the goldens; rank r >
    0 is given an empty directory of its own as its output prefix."""
    from rsem_tpu_torch.__main__ import main

    d = inputs["workdir"]
    rank = 0 if dist is None else dist.rank
    out = os.path.join(d, f"out{rank}" if rank else "", "w2" if dist
                       else "w1")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    assert main(["calculate-expression", "--alignments",
                 os.path.join(d, "in.sam"), os.path.join(d, "ref"), out,
                 *DRIVER_ARGS]) == 0
    return {"out": out}


def case_on_root(inputs, dist):
    """Work that writes files runs on rank 0 alone (distributed.on_root):
    its result, or its error, reaches every rank."""
    rank = 0 if dist is None else dist.rank

    def fails():
        raise ValueError("on rank 0")

    try:
        distributed.on_root(fails, dist)
        raised = None
    except Exception as e:  # the type each rank sees
        raised = type(e).__name__
    return {"value": distributed.on_root(lambda: 10 * rank + 7, dist),
            "raised": raised}


CASES = {"em_fused": case_em_fused, "em_windowed": case_em_windowed,
         "gibbs": case_gibbs, "ci": case_ci, "driver": case_driver,
         "on_root": case_on_root}


def _load_inputs(workdir):
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
        states = pickle.load(f)
    out = {"workdir": workdir}
    for k, (r, b, m) in states.items():
        ref = convert.reference_from_arrays(r)
        out[k] = (ref, convert.bundle_from_arrays(b),
                  convert.model_from_arrays(m, ref))
    return out


# the JAX package's run for each EM case: dataset, RSEM_TPU_FUSED_MODEL
JAX_CASES = {"em_fused": ("se", "1"), "em_windowed": ("pe", "0")}


def jax_main(workdir: str, case: str) -> None:
    """The JAX package's run_em on its 8-device CPU mesh (its sharded
    path) for one EM case: the per-round path (RSEM_TPU_FUSED_MODEL=0)
    for the windowed case, which the port's windows also take."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rsem_tpu.engine.em import EMConfig, run_em
    from rsem_tpu.testing import synthetic_dataset

    key, fused = JAX_CASES[case]
    os.environ["RSEM_TPU_FUSED_MODEL"] = fused
    ref, bundle, _spec, model = synthetic_dataset(**DATASETS[key])
    got = _em_result(run_em(model, ref, bundle, EMConfig(backend="device"),
                            need_posteriors=False))
    with open(os.path.join(workdir, f"jax_{case}.pkl"), "wb") as f:
        pickle.dump(got, f)


def rank_main(workdir: str) -> None:
    """One rank of the group (RSEM_TPU_* set by the parent): every case,
    its results pickled to workdir/rank<r>.pkl."""
    torch.set_num_threads(1)
    dist = distributed.maybe_initialize("cpu")
    inputs = _load_inputs(workdir)
    got = {name: fn(inputs, dist) for name, fn in CASES.items()}
    with open(os.path.join(workdir, f"rank{dist.rank}.pkl"), "wb") as f:
        pickle.dump(got, f)


# ------------------------------------------------------------------ #
# the group                                                          #
# ------------------------------------------------------------------ #
def _free_port() -> int:
    """A free port below Linux's ephemeral range (32768 up). A rank's store
    client retries its connect until rank 0 listens; on an ephemeral port
    one of those connects can draw the port itself as its source and
    connect to itself."""
    rng = random.Random(os.getpid() ^ time.time_ns())
    for _ in range(100):
        port = rng.randrange(20000, 32000)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port in 20000..32000")


class _Group:
    """The two rank processes and the JAX processes, started at once;
    `results()` waits for them and returns [rank 0's, rank 1's, JAX's by
    case]."""

    def __init__(self, workdir):
        self.workdir = workdir
        port = _free_port()
        base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
        envs = [dict(base, RSEM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                     RSEM_TPU_NUM_PROCESSES=str(WORLD),
                     RSEM_TPU_PROCESS_ID=str(r))
                for r in range(WORLD)]
        roles = [[]] * WORLD + [["jax", c] for c in JAX_CASES]
        envs += [dict(base, JAX_PLATFORMS="cpu", XLA_FLAGS=(
            "--xla_force_host_platform_device_count=8"))] * len(JAX_CASES)
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), workdir] + role,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for env, role in zip(envs, roles)]
        self._results = None

    def results(self):
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
            finally:
                for p in self.procs:
                    p.kill()
            for r, p in enumerate(self.procs):
                assert p.returncode == 0, f"process {r} failed:\n{logs[r]}"
            def load(name):
                with open(os.path.join(self.workdir, f"{name}.pkl"),
                          "rb") as f:
                    return pickle.load(f)

            self._results = [load(f"rank{r}") for r in range(WORLD)]
            self._results.append({c: load(f"jax_{c}") for c in JAX_CASES})
        return self._results


@pytest.fixture(scope="module", autouse=True)
def group(tmp_path_factory):
    from rsem_tpu.testing import synthetic_dataset

    d = str(tmp_path_factory.mktemp("parallel"))
    states = {}
    for k, kw in DATASETS.items():
        ref, bundle, _spec, model = synthetic_dataset(**kw)
        states[k] = tuple(convert.host_state(x) for x in (ref, bundle, model))
    with open(os.path.join(d, "inputs.pkl"), "wb") as f:
        pickle.dump(states, f)
    _golden_inputs(d)
    g = _Group(d)
    yield g
    for p in g.procs:
        p.kill()


@pytest.fixture(scope="module")
def world1(group):
    """The cases without a group, in this process, on the same inputs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    inputs = _load_inputs(group.workdir)
    out = {name: fn(inputs, None) for name, fn in CASES.items()}
    torch.set_num_threads(n)
    return out


# ------------------------------------------------------------------ #
# in process                                                         #
# ------------------------------------------------------------------ #
def _offsets(rng, n_reads):
    nh = rng.integers(0, 5, n_reads)  # empty reads too
    return np.concatenate([[0], np.cumsum(nh)]).astype(np.int64)


@pytest.mark.parametrize("n_reads,n_shards", [(1000, 2), (1000, 3),
                                              (37, 8), (3, 5), (0, 2)])
def test_partitions_match_jax(n_reads, n_shards):
    from rsem_tpu.parallel.distributed import process_read_bounds as jprb
    from rsem_tpu.parallel.fast_sharded import (
        partition_reads_by_hits as jpart,
    )

    offs = _offsets(np.random.default_rng(n_reads + n_shards), n_reads)
    want = jpart(offs, n_shards)
    np.testing.assert_array_equal(
        fast_sharded.partition_reads_by_hits(offs, n_shards), want)
    for arg in (offs, n_reads):
        for hb in (True, False):
            np.testing.assert_array_equal(
                distributed.process_read_bounds(arg, n_shards, hb),
                jprb(arg, n_shards, hb))


@pytest.mark.parametrize("paired,n_dev", [(False, 2), (False, 3),
                                          (True, 2), (True, 3)])
def test_shard_bundle_matches_jax_rows(paired, n_dev):
    """Each rank's slice equals the unpadded rows of the JAX package's
    shard of that index."""
    from rsem_tpu.parallel.mesh import shard_bundle_by_read as jshard
    from rsem_tpu.testing import synthetic_dataset

    _ref, jb, _spec, _m = synthetic_dataset(n_reads=300, M=20, read_len=30,
                                            tx_len=200, paired=paired,
                                            mean_extra_hits=1.5, seed=2)
    want = jshard(jb, n_dev)
    tb = convert.bundle_from_arrays(convert.host_state(jb))
    for d in range(n_dev):
        sh = mesh.shard_bundle_by_read(tb, n_dev, d)
        b, n, h = sh.bundle, sh.read_sizes[d], sh.hit_sizes[d]
        assert (b.hits.n_reads, b.hits.n_hits) == (n, h)
        for f, g in (("rid", "rid"), ("sid", "sid"), ("dir", "dir"),
                     ("pos", "pos")) + ((("insert_len", "insert_len"),)
                                        if paired else ()):
            np.testing.assert_array_equal(
                getattr(b.hits, f), np.asarray(getattr(want.hits, g))[d, :h])
        np.testing.assert_array_equal(
            b.hits.read_offsets, np.asarray(want.read_offsets)[d, :n + 1])
        mates = ((b.reads.mate1, want.m1), (b.reads.mate2, want.m2)) \
            if paired else ((b.reads, want.m1),)
        for got, w in mates:
            np.testing.assert_array_equal(got.codes,
                                          np.asarray(w.codes)[d, :n])
            np.testing.assert_array_equal(got.lens, np.asarray(w.lens)[d, :n])
            np.testing.assert_array_equal(got.quals,
                                          np.asarray(w.quals)[d, :n])
            np.testing.assert_array_equal(got.lq, np.asarray(w.lq)[d, :n])
        assert b.cnt is tb.cnt


def _theta_data(rng, N, M, n0=3.0):
    nh = rng.integers(0, 5, N)
    offs = np.concatenate([[0], np.cumsum(nh)])
    H = int(offs[-1])
    return theta.ThetaData(
        sid=torch.as_tensor(rng.integers(1, M + 1, H), dtype=torch.int32),
        rid=torch.as_tensor(np.repeat(np.arange(N), nh), dtype=torch.int32),
        cps=torch.as_tensor(rng.random(H), dtype=torch.float32),
        ncs=torch.as_tensor(rng.random(N) * 0.1, dtype=torch.float32),
        read_offsets=torch.as_tensor(offs), M=M, n0=n0)


def test_theta_partial_finish_equal_whole_round():
    """K1's plain partial round on each of three read slices, summed, then
    its plain finish: the plain whole round's theta, counts and stop count
    (rtol 1e-12)."""
    rng = np.random.default_rng(0)
    data = _theta_data(rng, 2000, 150)
    th = torch.as_tensor(rng.dirichlet(np.ones(151)), dtype=torch.float32)
    want = theta.theta_round_plain(th, data)
    offs = data.read_offsets.numpy()
    cuts = fast_sharded.partition_reads_by_hits(offs, 3)
    red = torch.zeros(152, dtype=torch.float64)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        h0, h1 = int(offs[lo]), int(offs[hi])
        part = theta.ThetaData(
            data.sid[h0:h1], data.rid[h0:h1] - int(lo), data.cps[h0:h1],
            data.ncs[lo:hi], data.read_offsets[lo:hi + 1] - h0, 150,
            data.n0)
        red += theta.theta_partial_plain(th, part)
    got = theta.theta_finish_plain(th, red, data.n0)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), want[1].numpy(), rtol=1e-12)
    assert int(got[2]) == int(want[2])


def test_k5_chain0_replays_its_chains():
    """The plain K5 on chains 4-7 with chain0 = 4, from init_chains' slice
    of an 8-chain draw: chains 4-7 of the 8-chain run, exactly."""
    hits, lcp, lnp = synthetic_gibbs_hits(1500, 80, seed=9, max_hits=5)
    layout = gibbs.build_layout(hits, lcp, lnp, 80, device="cpu")
    base = torch.ones(81)
    a8, t8 = gibbs.init_chains(layout, base, 8, seed=2)
    a4, t4 = gibbs.init_chains(layout, base, 8, seed=2, chains=slice(4, 8))
    assert torch.equal(t4, t8[4:])
    for s in range(3):
        for pi, part in enumerate(layout.parts):
            sp = gibbs.part_seed(6, pi)
            gibbs.sweep_part(a8[pi], t8, part, sp, s)
            gibbs.sweep_part(a4[pi], t4, part, sp, s, chain0=4)
    assert torch.equal(t4, t8[4:])
    for a, b in zip(a4, a8):
        assert torch.equal(a, b[4:])
    u = gibbs.read_uniforms(1, 2, 3, 4, 8, chain0=4)
    assert torch.equal(u, gibbs.read_uniforms(1, 2, 3, 8, 8)[4:])


@pytest.mark.parametrize("seed", [0, 1])
def test_group_sums_add_members_in_column_order(seed):
    """CI's group sums: each group's members added one after another from
    0, whatever the other groups' sizes, so a block cut at group
    boundaries (a rank's share) sums its groups to the same bits."""
    from rsem_tpu_torch.engine.ci import _segment_sums

    rng = np.random.default_rng(seed)
    sizes = np.minimum(rng.zipf(1.6, 40), 50)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    rows = torch.as_tensor(rng.gamma(0.3, 1e3, (int(starts[-1]), 23)),
                           dtype=torch.float32)
    want = torch.zeros((len(sizes), 23))
    for g in range(len(sizes)):
        for c in range(int(starts[g]), int(starts[g + 1])):
            want[g] += rows[c]
    assert torch.equal(_segment_sums(rows, sizes), want)
    cut = 17
    assert torch.equal(_segment_sums(rows[int(starts[cut]):], sizes[cut:]),
                       want[cut:])


def test_group_bounds_blocks_keep_the_bits(monkeypatch):
    """Gene intervals taken a few groups at a time (a small
    GROUP_BLOCK_BYTES) equal those taken all at once, at skewed sizes."""
    from rsem_tpu_torch.engine import ci

    rng = np.random.default_rng(3)
    sizes = np.minimum(rng.zipf(1.6, 60), 40)
    starts = np.concatenate([[1], 1 + np.cumsum(sizes)])
    M, n = int(starts[-1]) - 1, 200
    tpm = torch.as_tensor(rng.gamma(0.5, 50.0, (n, M)), dtype=torch.float32)
    inv = torch.as_tensor(1e3 / rng.uniform(1500, 1600, (n, 1)),
                          dtype=torch.float32)
    z = ci.CIBounds(np.zeros(M), np.zeros(M), np.zeros(M))
    gi = GroupInfo(starts)
    whole = ci.group_bounds(tpm, inv, gi, z, z, 190)
    monkeypatch.setattr(ci, "GROUP_BLOCK_BYTES", 30 * 4 * n)
    blocks = ci.group_bounds(tpm, inv, gi, z, z, 190)
    for a, b in zip(whole, blocks):
        for f in ("lb", "ub", "cqv"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_maybe_initialize_raises_without_coordinator(monkeypatch):
    """The variables set, nobody listening at the coordinator: the entry
    raises; it does not go on as one process."""
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(distributed, "_handle", None)
    # port 1: nothing listens there, and no free port of the group's
    monkeypatch.setenv("RSEM_TPU_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("RSEM_TPU_NUM_PROCESSES", "2")
    monkeypatch.setenv("RSEM_TPU_PROCESS_ID", "1")
    monkeypatch.setattr(distributed, "GROUP_TIMEOUT_S", 1.0)
    with pytest.raises(Exception):
        distributed.maybe_initialize("cpu")
    assert not distributed._initialized
    assert not torch.distributed.is_initialized()


# ------------------------------------------------------------------ #
# the two-process group against world 1                              #
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("case", ["em_fused", "em_windowed"])
def test_two_ranks_em_equals_world_one(group, world1, case):
    r0, r1 = (r[case] for r in group.results()[:WORLD])
    w1 = world1[case]
    assert abs(r0["rounds"] - w1["rounds"]) <= 2
    for k in ("counts", "tpm", "frac_hit", "frac_noise", "pro", "npro"):
        np.testing.assert_allclose(r0[k], w1[k], rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    if case == "em_windowed":
        assert w1["windows"] > 1 and r0["windows"] > 1
        np.testing.assert_allclose(r0["gld"], w1["gld"], rtol=1e-5)
    for k, v in r0.items():  # every rank holds the same result
        np.testing.assert_array_equal(r1[k], v, err_msg=k)


def test_two_ranks_gibbs_identical(group, world1):
    """Chains 0-1 on rank 0, 2-3 on rank 1: the count vectors of one
    process, exactly."""
    r0, r1 = (r["gibbs"] for r in group.results()[:WORLD])
    for k, v in world1["gibbs"].items():
        np.testing.assert_array_equal(r0[k], v, err_msg=k)
        np.testing.assert_array_equal(r1[k], v, err_msg=k)


def test_two_ranks_ci_identical(group, world1):
    """Rows then transcript columns split over the ranks: every bound of
    one process, exactly, on both ranks."""
    r0, r1 = (r["ci"] for r in group.results()[:WORLD])
    for k, v in world1["ci"].items():
        np.testing.assert_array_equal(r0[k], v, err_msg=k)
        np.testing.assert_array_equal(r1[k], v, err_msg=k)


def test_two_ranks_on_root(group, world1):
    """Rank 0's value on both ranks; rank 0's error raised on both (its
    own on rank 0, a RuntimeError naming it on rank 1)."""
    r0, r1 = (r["on_root"] for r in group.results()[:WORLD])
    assert r0["value"] == r1["value"] == world1["on_root"]["value"] == 7
    assert r0["raised"] == world1["on_root"]["raised"] == "ValueError"
    assert r1["raised"] == "RuntimeError"


def _table(path):
    rows = [line.rstrip("\n").split("\t") for line in open(path)]
    hdr = rows[0]
    return hdr, {r[0]: r for r in rows[1:]}


def test_two_ranks_driver(group, world1):
    """The driver on two ranks against one process: .cnt identical,
    expected counts and TPM within rtol 1e-5, posterior means within
    max(2 sd, 1.5), CI bounds at the golden tolerances; rank 1 wrote
    nothing under its output prefix."""
    res = group.results()
    w2, w1 = res[0]["driver"]["out"], world1["driver"]["out"]
    assert open(f"{w2}.stat/w2.cnt").read() == open(f"{w1}.stat/w1.cnt").read()
    rank1_dir = os.path.dirname(res[1]["driver"]["out"])
    assert os.listdir(rank1_dir) == []
    for kind in ("isoforms", "genes"):
        h, got = _table(f"{w2}.{kind}.results")
        h1, want = _table(f"{w1}.{kind}.results")
        assert h == h1 and got.keys() == want.keys()
        col = {c: h.index(c) for c in h}
        for tid, w in want.items():
            g = got[tid]
            for c in ("expected_count", "TPM"):
                assert float(g[col[c]]) == pytest.approx(
                    float(w[col[c]]), rel=1e-5, abs=1e-8), (tid, c)
            sd = max(float(w[col["posterior_standard_deviation_of_count"]]),
                     float(g[col["posterior_standard_deviation_of_count"]]))
            pme = col["posterior_mean_count"]
            assert abs(float(g[pme]) - float(w[pme])) <= max(2 * sd, 1.5)
            lb, ub = col["TPM_ci_lower_bound"], col["TPM_ci_upper_bound"]
            width = max(float(w[ub]) - float(w[lb]), 1.0)
            for i in (lb, ub):
                assert abs(float(g[i]) - float(w[i])) < 0.12 * width + 0.5
            cqv = col["TPM_coefficient_of_quartile_variation"]
            assert float(g[cqv]) == pytest.approx(float(w[cqv]), abs=0.03,
                                                  rel=0.12)


@pytest.mark.parametrize("case", ["em_fused", "em_windowed"])
def test_sharded_em_matches_jax(group, world1, case):
    """Rank 0's EM against the JAX package's run_em on its 8-device CPU
    mesh (jax_main), at tests/test_torch_em.py::test_converged_run's
    tolerances. (Last, and after world1: this process computes world 1
    while the JAX process still runs.)"""
    res = group.results()
    got, want = res[0][case], res[WORLD][case]
    assert got["rounds"] == want["rounds"]
    for k in ("counts", "tpm"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-2,
                                   err_msg=k)
    np.testing.assert_allclose(got["counts"].sum(), want["counts"].sum(),
                               rtol=1e-6)
    for k in ("pro", "npro"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    if want["gld"] is not None:
        np.testing.assert_allclose(got["gld"], want["gld"], rtol=1e-4,
                                   atol=1e-9)


if __name__ == "__main__":
    if sys.argv[2:3] == ["jax"]:
        jax_main(sys.argv[1], sys.argv[3])
    else:
        rank_main(sys.argv[1])
