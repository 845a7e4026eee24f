"""rsem_tpu_torch: the PyTorch/CUDA port of rsem_tpu.

A second package beside the JAX one (which stays the reference). Modules
mirror rsem_tpu's layout so each has a counterpart of the same path:

refprep, io, model, constants, utils/seq, testing
          copies of rsem_tpu's host modules (numpy only); the port imports
          nothing from rsem_tpu
utils     device selection (`resolve_device`), timing
ops       device layout, conprb/PreIdx (whole or in windows), E-step,
          theta rounds, and the hand-written CUDA kernels' wrappers
          (sources in csrc/, built by ops/_build.py on first use)
native    the C++ host sidecars, built with g++ on first use: BAM/SAM
          ingest and BGZF compression (bamparse), the EM backends
          hybrid and native (suffstats)
engine    EM, Gibbs, CI, the read simulator
pipeline  calculate-expression, prepare-reference (host only) and
          simulate-reads entry points; aligner command lines
convert   carries host objects and model tables across

Entry points run on CUDA unless the caller passes device="cpu"
(CLI: --device cpu); without CUDA and without that, they raise.
"""

__version__ = "0.1.0"
