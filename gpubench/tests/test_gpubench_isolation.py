"""What the harness and its reference import, and the harness's call
sequence against calculate-expression's."""

import inspect
import json
import os
import re
import subprocess
import sys


from gpubench.tests.conftest import ROOT

NEVER = ("jax", "jaxlib", "flax", "rsem_tpu")


def _loaded(modules):
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"for m in {list(modules)!r}: __import__(m)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    top = _loaded(["gpubench.reference.em", "gpubench.reference.model",
                   "gpubench.reference.compare",
                   "gpubench.gen.synth", "gpubench.yardstick.work",
                   "gpubench.yardstick.peaks"])
    assert not top & set(NEVER)
    assert "rsem_tpu_torch" not in top


def test_harness_imports_no_jax():
    top = _loaded(["gpubench.harness", "gpubench.sut", "gpubench.trace",
                   "gpubench.readers", "gpubench.control",
                   "gpubench.gen.bundle"])
    assert not top & set(NEVER)  # compared whole: rsem_tpu_torch is allowed
    assert "rsem_tpu_torch" in top


def test_no_source_of_the_benchmark_names_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|rsem_tpu)\b"
                     r"(?!_torch)", re.M)
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "gpubench")):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert not pat.search(text), f


STEPS = ["clear_device_cache", "GenerativeModel", "estimate_from_stats",
         "run_em", "gene_level_values"]


def _order(text, names):
    pos = {n: text.find(n + "(") for n in names}
    assert all(p >= 0 for p in pos.values()), pos
    return sorted(names, key=pos.get)


def test_call_sequence_follows_calculate_expression():
    """The sample operation makes calculate-expression's estimation calls
    of its default path in its order (pipeline/calculate_expression.py,
    the EM stage)."""
    from rsem_tpu_torch.pipeline import calculate_expression as ce

    from gpubench import sut

    src = inspect.getsource(ce)
    em = src.index("# ---- EM ----")
    stages = src[em:src.index("# ---- final tables ----")]
    mine = inspect.getsource(sut.run_sample)
    steps = STEPS[1:]
    assert _order(stages, steps) == steps
    assert _order(mine, STEPS) == STEPS
    # the same arguments where they matter: the default path (no
    # --calc-pme, no --calc-ci) asks run_em for no posteriors
    assert "EMConfig()" in mine and "need_posteriors=False" in mine
    assert "need_posteriors=" in stages


def test_call_sequence_recorded(monkeypatch):
    """Recorded calls of a run's samples (on the CPU, small)."""
    import argparse
    import io
    from pathlib import Path

    from gpubench import harness, sut
    from gpubench.tests.conftest import SMALL

    calls = []

    def wrap(name):
        real = getattr(sut, name)

        def rec(*a, **kw):
            calls.append(name)
            return real(*a, **kw)
        monkeypatch.setattr(sut, name, rec)

    for n in ("clear_device_cache", "run_em", "gene_level_values"):
        wrap(n)
    a = argparse.Namespace(workload="tcga_cells_em", seed=9, seconds=0.1,
                           trace=0, override=dict(SMALL, samples=1))
    assert harness.run(a, device="cpu", check_chip=False, root=Path(ROOT),
                       out=io.StringIO(), err=io.StringIO()) == 0
    assert calls[:3] == ["clear_device_cache", "run_em", "gene_level_values"]
    assert len(calls) % 3 == 0 and calls == calls[:3] * (len(calls) // 3)
