"""Differential expression subsystem (the reference's EBSeq/ add-on):
native empirical-Bayes NB-Beta mixture testing, Ng-vector generation and
FDR control — no R runtime required."""

from .ebseq import (
    EBMultiResult,
    EBTestResult,
    crit_fun,
    eb_multi_test,
    eb_test,
    get_normalized_mat,
    get_patterns,
    median_norm,
)
from .ngvector import generate_ngvector, ng_vector_from_scores, unmappability
from .runner import control_fdr, read_data_matrix, run_ebseq

__all__ = [
    "EBMultiResult",
    "EBTestResult",
    "crit_fun",
    "eb_multi_test",
    "eb_test",
    "get_normalized_mat",
    "get_patterns",
    "median_norm",
    "generate_ngvector",
    "ng_vector_from_scores",
    "unmappability",
    "control_fdr",
    "read_data_matrix",
    "run_ebseq",
]
