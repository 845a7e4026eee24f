"""pRSEM: ChIP-seq-informed priors for the Gibbs sampler.

Native reimplementation of the reference's pRSEM add-on (pRSEM/Prsem.py,
pRSEM/process-rnaseq.R, pRSEM/prsem-calculate-expression): all 15
partition models (pk, pk_lgtnopk, lm3-6, nopk_lm2-5pk, pk_lm2-5nopk,
cmb_lgt), the ChIP-seq input leg (bowtie alignment, tagAlign, strand
cross-correlation fragment length, Poisson peak calling, replicate
reproducibility), partitioned Dirichlet-multinomial prior fitting,
informativeness testing (one-sided Wilcoxon), and the Gibbs rerun with
the learned pseudo-counts.
"""

from .coords import Mappability, TrCoord, build_coords
from .features import read_peaks, tss_peak_flags
from .partition import (
    PARTITION_MODELS,
    TranscriptFeatures,
    compute_partition,
    count_region_signal,
    read_tagalign,
    region_peak_flags,
)
from .prior import (
    dm_log_likelihood,
    fit_partitioned_dm,
    informative_pvalue,
    write_prior_file,
)
from .runner import PrsemConfig, build_features, learn_prior, \
    run_testing_procedure
from .training import select_training_set

__all__ = [
    "Mappability",
    "TrCoord",
    "build_coords",
    "read_peaks",
    "tss_peak_flags",
    "PARTITION_MODELS",
    "TranscriptFeatures",
    "compute_partition",
    "count_region_signal",
    "read_tagalign",
    "region_peak_flags",
    "dm_log_likelihood",
    "fit_partitioned_dm",
    "informative_pvalue",
    "write_prior_file",
    "PrsemConfig",
    "build_features",
    "learn_prior",
    "run_testing_procedure",
    "select_training_set",
]
