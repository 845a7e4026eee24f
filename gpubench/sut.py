"""The system under test: the port's estimation stages for one parsed sample.

One operation is one sample, through the calls calculate-expression makes
between the parse and the tables on its default path (no --calc-pme, no
--calc-ci: `rsem_tpu_torch/pipeline/calculate_expression.py`, the EM
stage), in its order:

1. `ops.layout.clear_device_cache()`: a fresh calculate-expression process
   starts with no layout on the card;
2. a fresh `GenerativeModel(spec, ref)` and `estimate_from_stats` (run_em
   refits the model in place, so none is reused);
3. `engine.em.run_em(model, ref, bundle, EMConfig(),
   need_posteriors=False)`;
4. `io.results.gene_level_values(...)`.

Each stage runs inside a `torch.profiler.record_function` span of its own
name, which the traced run's breakdown labels idle gaps with, and its host
time is kept (`Sample.spans`). The sample ends synchronised.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function

from rsem_tpu_torch.engine.em import EMConfig, run_em
from rsem_tpu_torch.io.results import gene_level_values
from rsem_tpu_torch.model import GenerativeModel
from rsem_tpu_torch.ops.layout import clear_device_cache


@dataclass
class Inputs:
    """One distinct sample as calculate-expression holds it after the parse."""

    index: int
    ref: object  # refprep.Reference
    gi: object  # refprep.transcripts.GroupInfo
    spec: object  # model.ModelSpec
    bundle: object  # io.AlignmentBundle
    tlens: np.ndarray  # [M+1] transcript lengths


@dataclass
class Sample:
    """What one pass produced: host spans, counters and the values the
    comparison judges."""

    index: int
    seconds: float
    spans: Dict[str, float] = field(default_factory=dict)
    rounds: int = 0
    peak_bytes: int = 0
    values: Dict[str, np.ndarray] = field(default_factory=dict)


def _span(spans: Dict[str, float], name: str):
    class _S:
        def __enter__(self):
            self.rf = record_function(f"gpubench.{name}")
            self.rf.__enter__()
            self.t = time.perf_counter()

        def __exit__(self, *exc):
            spans[name] = time.perf_counter() - self.t
            self.rf.__exit__(*exc)
            return False

    return _S()


def run_sample(inp: Inputs, device, keep_values: bool = True) -> Sample:
    """Run the estimation stages once on `inp`."""
    spans: Dict[str, float] = {}
    t0 = time.perf_counter()
    with _span(spans, "clear_cache"):
        clear_device_cache()
    with _span(spans, "model_init"):
        model = GenerativeModel(inp.spec, inp.ref)
        model.estimate_from_stats(inp.bundle.stats)
    with _span(spans, "em"):
        em = run_em(model, inp.ref, inp.bundle, EMConfig(),
                    need_posteriors=False, device=device)
    with _span(spans, "gene_level"):
        gl = gene_level_values(inp.gi, inp.tlens, em.eel, em.counts, em.tpm,
                               em.fpkm)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    out = Sample(inp.index, time.perf_counter() - t0, spans, int(em.rounds))
    if keep_values:
        out.values = {"iso_count": em.counts, "iso_tpm": em.tpm,
                      "iso_fpkm": em.fpkm, "gene_count": gl.counts,
                      "gene_tpm": gl.tpm, "gene_fpkm": gl.fpkm}
    return out
