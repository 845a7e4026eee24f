"""Plotting subsystem: model diagnostics and transcript wiggle plots.

Matplotlib-native replacements for the reference's R plotting scripts
(rsem-plot-model, rsem-plot-transcript-wiggles, rsem-gen-transcript-plots).
"""

from .plot_model import plot_model
from .transcript_wiggles import gen_transcript_plots, plot_transcript_wiggles

__all__ = [
    "plot_model",
    "plot_transcript_wiggles",
    "gen_transcript_plots",
]
