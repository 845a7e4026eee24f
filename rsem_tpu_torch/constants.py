"""Numeric constants shared across the framework.

These mirror the reference's global constants (reference: utils.h:18-26) so
that statistical behavior matches RSEM within tolerance.
"""

# Probabilities below EPSILON are treated as exact zeros (utils.h:19).
EPSILON = 1e-300

# Minimum expected effective length; eel below this is zeroed (utils.h:20).
MINEEL = 1.0

# Threshold on P(forward strand) used to pick the strand for RSPD updates
# (utils.h:21, SingleModel.h update).
ORIVALVE = 0.1

# Width of the discretized Normal fragment-length distribution and the cap on
# (maxL - minL + 1) for user-specified fragment dists (utils.h:22).
RANGE = 201

# Overlap length: number of 5' seed bases that must not fall in the poly(A)
# tail; drives fmask construction and the low-quality read filter (utils.h:23).
OLEN = 25

# Bits per word in the serialized fmask arrays of .seq files (utils.h:24).
NBITS = 32

# Number of base codes: A C G T N.
NCODES = 5

# Quality-score alphabet size for QualDist / QProfile (QualDist.h:33,
# QProfile.h:36): printable Phred+33 scores 0..93 stored in a 100-wide table.
QSIZE = 100

# Default poly(A) tail length (rsem-prepare-reference --polyA-length).
DEFAULT_POLYA_LEN = 125

# Default number of RSPD bins (RSPD.h:13).
RSPD_DEFAULT_B = 20

# EM convergence (EM.cpp:53-55): relative change < STOP_CRITERIA on every
# theta >= THETA_CUT, at least MIN_ROUND and at most MAX_ROUND rounds.
STOP_CRITERIA = 1e-3
THETA_CUT = 1e-7
MIN_ROUND = 20
MAX_ROUND = 10000

# Model parameters are re-estimated only during the first rounds
# (EM.cpp:307-310).
UPDATE_MODEL_ROUNDS = 10

# Default maximum read/fragment length (ModelParams defaults; Profile.h:46).
DEFAULT_MAXL = 1000
DEFAULT_MINL = 1

# Default seed length (rsem-calculate-expression --seed-length).
DEFAULT_SEED_LEN = 25
