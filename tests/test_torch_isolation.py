"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the JAX
package, and its entry points never fall back to the CPU unasked."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "rsem_tpu_torch")


def _port_modules():
    mods = []
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_port_imports_with_jax_blocked():
    """In a fresh interpreter (the test session has jax loaded via
    conftest.py), import every port module with jax made unimportable;
    no rsem_tpu module may end up loaded."""
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'rsem_tpu' or "
        "m.startswith('rsem_tpu.') or m == 'jax' and sys.modules[m]]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 30
    assert {"rsem_tpu_torch.native",
            "rsem_tpu_torch.ops.model_loop",
            "rsem_tpu_torch.engine.simulate",
            "rsem_tpu_torch.pipeline.simulate_reads",
            "rsem_tpu_torch.pipeline.prepare_reference",
            "rsem_tpu_torch.pipeline.aligners",
            "rsem_tpu_torch.refprep.gtf",
            "rsem_tpu_torch.refprep.gff3",
            "rsem_tpu_torch.refprep.extract",
            "rsem_tpu_torch.refprep.synthesis",
            "rsem_tpu_torch.refprep.prepare",
            "rsem_tpu_torch.prsem.runner",
            "rsem_tpu_torch.prsem.chipseq",
            "rsem_tpu_torch.pipeline.utilities",
            "rsem_tpu_torch.diffexp.ebseq",
            "rsem_tpu_torch.plots.plot_model",
            "rsem_tpu_torch.plots.transcript_wiggles"} <= set(_port_modules())


def test_native_ingest_imports_with_jax_blocked():
    """The sidecar's bindings and the native path of io/sam.py, run on a
    golden SAM in a fresh interpreter with jax made unimportable, load no
    jax and no rsem_tpu module."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from rsem_tpu_torch.io.sam import parse_alignments\n"
        "from rsem_tpu_torch.native import bamparse\n"
        "from rsem_tpu_torch.refprep.transcripts import Transcripts\n"
        "ti = Transcripts.read_ti('tests/goldens/ref.ti')\n"
        "names = [''] + [t.transcript_id for t in ti.transcripts]\n"
        "b = parse_alignments('tests/goldens/aln.sam.gz', names, 1, False, "
        "25, use_native=True)\n"
        "assert bamparse._lib is not None and b.cnt.N1 > 0\n"
        "bad = [m for m in sys.modules if m == 'rsem_tpu' or "
        "m.startswith('rsem_tpu.') or m == 'jax' and sys.modules[m]]\n"
        "print(b.cnt.N1, bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) > 0


def test_native_ingest_raises_without_gxx(monkeypatch, tmp_path):
    """use_native=True never drops to Python quietly: with no g++ (and no
    earlier build) the call raises, naming the compiler."""
    from rsem_tpu_torch import native
    from rsem_tpu_torch.io.sam import open_alignment_file, parse_alignments
    from rsem_tpu_torch.native import bamparse

    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "_build")
    monkeypatch.setattr(native.shutil, "which", lambda _name: None)
    monkeypatch.setattr(bamparse, "_lib", None)
    sam = os.path.join(ROOT, "tests", "goldens", "aln.sam.gz")
    reader = open_alignment_file(sam)
    names = [""] + list(reader.target_names)
    reader.close()
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        parse_alignments(sam, names, 1, False, 25, use_native=True)
    assert not (tmp_path / "_build").exists() or not any(
        (tmp_path / "_build").rglob("*.so"))
    # the explicit Python path still runs
    assert parse_alignments(sam, names, 1, False, 25,
                            use_native=False).cnt.N1 > 0


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("target", ["rsem_tpu_torch", "chip_smoke.py"])
def test_no_jax_or_rsem_tpu_imports(target):
    path = os.path.join(ROOT, target)
    files = [path] if path.endswith(".py") else [
        os.path.join(d, f) for d, _s, fs in os.walk(path) for f in fs
        if f.endswith(".py")]
    assert files
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "rsem_tpu"), (f, name)


def _tiny():
    from rsem_tpu_torch.testing import synthetic_dataset

    return synthetic_dataset(n_reads=50, M=5, read_len=30, tx_len=200,
                             seed=1)


def test_entry_points_refuse_missing_cuda(tmp_path):
    """With no CUDA and no explicit device="cpu", run_em, run_gibbs, run_ci
    and calculate_expression raise instead of running on the CPU; the kernel
    wrappers never take their plain version for a CUDA tensor."""
    if torch.cuda.is_available():
        pytest.skip("this check is about machines without CUDA")
    from rsem_tpu_torch.engine.ci import CIConfig, run_ci
    from rsem_tpu_torch.engine.em import run_em
    from rsem_tpu_torch.engine.gibbs import GibbsConfig, run_gibbs
    from rsem_tpu_torch.pipeline.calculate_expression import (
        calculate_expression,
    )
    from rsem_tpu_torch.refprep.transcripts import GroupInfo

    ref, bundle, _spec, model = _tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_em(model, ref, bundle)
    M, gi = ref.M, GroupInfo(np.arange(1, ref.M + 2))
    ones = np.ones(M + 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_gibbs(bundle.hits, np.zeros(bundle.hits.n_hits),
                  np.zeros(bundle.hits.n_reads), M, 0, ones, ones, gi,
                  GibbsConfig(burnin=1, nsamples=8))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_ci(np.ones((4, M + 1)), ones, ones, gi, CIConfig(nspc=2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calculate_expression(str(tmp_path / "x.sam"), str(tmp_path / "ref"),
                             str(tmp_path / "out"))
    from rsem_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["calculate-expression", "--alignments", "x.sam", "ref", "out"])


def test_unported_options_raise(tmp_path, monkeypatch):
    """pRSEM's three refusals raise the JAX driver's ValueErrors (allele
    mode; no --calc-pme; no ChIP-seq input), before any alignment is read;
    an unknown EM backend raises."""
    from rsem_tpu_torch.__main__ import main
    from rsem_tpu_torch.engine.em import EMConfig, run_em
    from rsem_tpu_torch.pipeline.calculate_expression import (
        ExpressionConfig,
        calculate_expression,
    )

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACGT"), size=300)) for _ in range(3)]
    (tmp_path / "tx.fa").write_text("".join(
        f">t{i}\n{q}\n" for i, q in enumerate(seqs)))
    (tmp_path / "alleles.fa").write_text("".join(
        f">a{i}\n{q}\n" for i, q in enumerate(seqs)))
    (tmp_path / "amap.txt").write_text("gA tX a0\ngA tX a1\ngB tY a2\n")
    assert main(["prepare-reference", "tx.fa", "ref", "-q"]) == 0
    assert main(["prepare-reference", "--allele-to-gene-map", "amap.txt",
                 "alleles.fa", "aref", "-q"]) == 0
    peaks = dict(chipseq_peak_file="peaks.bed")
    for ref, kw, msg in (
            ("aref", dict(calc_pme=True, **peaks), "allele mode"),
            ("ref", dict(**peaks), "requires --calc-pme"),
            ("ref", dict(calc_pme=True), "requires --chipseq-peak-file")):
        with pytest.raises(ValueError, match=msg):
            calculate_expression("missing.sam", ref, "o",
                                 ExpressionConfig(run_prsem=True, **kw),
                                 device="cpu")
    assert not os.path.exists("o.isoforms.results")
    ref, bundle, _spec, model = _tiny()
    with pytest.raises(ValueError, match="unknown EM backend"):
        run_em(model, ref, bundle, EMConfig(backend="xla"), device="cpu")


def test_cpu_wrappers_run_plain_versions():
    """On CPU tensors every kernel wrapper computes through its plain
    version and counts no launch."""
    from rsem_tpu_torch.ops import conprb, gibbs, table, theta
    from rsem_tpu_torch.testing import synthetic_gibbs_hits

    before = (table.gather_sum.launches, table.scatter_add.launches,
              theta.theta_round.launches, conprb.preidx_flat.launches,
              gibbs.sweep_part.launches)
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, 11, size=(6, 8)), dtype=torch.int32)
    tab = table.padded_table(torch.arange(10, dtype=torch.float32), 10)
    np.testing.assert_allclose(table.gather_sum(tab, idx).numpy(),
                               tab.numpy()[idx.numpy()].sum(1), rtol=1e-6)
    w = torch.ones(6)
    got = table.scatter_add(idx, w, 10).numpy()
    np.testing.assert_array_equal(got, np.bincount(
        idx.numpy().reshape(-1), minlength=11)[:10])
    hits, lcp, lnp = synthetic_gibbs_hits(60, 12, seed=0, max_hits=3)
    layout = gibbs.build_layout(hits, lcp, lnp, 12)
    base = torch.ones(13)
    assigns, tab_k = gibbs.init_chains(layout, base, 2, seed=1)
    assigns_p = [a.clone() for a in assigns]
    tab_p = tab_k.clone()
    for pi, part in enumerate(layout.parts):
        gibbs.sweep_part(assigns[pi], tab_k, part, 5, 0)
        gibbs.sweep_part_plain(assigns_p[pi], tab_p, part, 5, 0)
        assert torch.equal(assigns[pi], assigns_p[pi])
    assert torch.equal(tab_k, tab_p)
    after = (table.gather_sum.launches, table.scatter_add.launches,
             theta.theta_round.launches, conprb.preidx_flat.launches,
             gibbs.sweep_part.launches)
    assert after == before
