"""The default path (no --calc-pme, no --calc-ci): one sample through the
calls calculate-expression makes between the parse and the tables
(`rsem_tpu_torch/pipeline/calculate_expression.py`, the EM stage), in its
order:

1. `ops.layout.clear_device_cache()`: a fresh calculate-expression process
   starts with no layout on the card;
2. a fresh `GenerativeModel(spec, ref)` and `estimate_from_stats` (run_em
   refits the model in place, so none is reused);
3. `engine.em.run_em(model, ref, bundle, EMConfig(),
   need_posteriors=False)`;
4. `io.results.gene_level_values(...)`.

It is judged by the plain EM (`reference/em.py`) at RSEM's own stop, with
the six numbers of `reference/compare.py`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from rsem_tpu_torch.engine.em import EMConfig, run_em
from rsem_tpu_torch.io.results import gene_level_values
from rsem_tpu_torch.model import GenerativeModel
from rsem_tpu_torch.ops.layout import clear_device_cache

from gpubench.reference import compare
from gpubench.reference.em import (CONTROL, REFERENCE, STATED, Expression,
                                   reference_expression)
from gpubench.sut import Inputs, Sample, _span
from gpubench.yardstick.work import Work

NUMBERS = compare.NUMBERS
PRECISIONS = {"reference": REFERENCE, "stated": STATED, "control": CONTROL}


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


def work(inp: Inputs, sample: Sample) -> Dict:
    """The yardstick's sizes of one sample as it ran."""
    model_rounds = EMConfig().update_model_rounds
    return Work(hits=inp.bundle.hits.n_hits, reads=inp.bundle.hits.n_reads,
                isoforms=inp.ref.M,
                read_len=int(inp.bundle.reads.mate1.codes.shape[1]),
                model_rounds=model_rounds,
                theta_rounds=max(sample.rounds - model_rounds,
                                 0))._asdict()


@dataclass
class Want:
    """The reference's expression values of one sample, and one read's
    worth of each value (`compare.read_units`)."""

    expr: Expression
    units: Dict[str, np.ndarray]

    @property
    def values(self) -> Dict[str, np.ndarray]:
        e = self.expr
        return {"iso_count": e.counts, "iso_tpm": e.tpm, "iso_fpkm": e.fpkm,
                "gene_count": e.gene_counts, "gene_tpm": e.gene_tpm,
                "gene_fpkm": e.gene_fpkm}

    @property
    def rounds(self) -> int:
        return self.expr.rounds


def reference(ann, raw, config: Dict, device, precision: str) -> Want:
    expr = reference_expression(ann, raw, config, device,
                                PRECISIONS[precision])
    return Want(expr, compare.read_units(expr, ann.iso_gene, ann.n_genes))


def gaps(values: Dict[str, np.ndarray], want: Want, ann) -> Dict[str, float]:
    return compare.gaps(values, want.expr, want.units)
