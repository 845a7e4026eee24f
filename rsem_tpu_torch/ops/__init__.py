from .layout import RefDevice, ReadsDevice, HitsDevice, KernelConfig
from .conprb import compute_log_conprb, compute_log_noise_conprb
from .estep import estep_fracs, suffstats

__all__ = [
    "RefDevice",
    "ReadsDevice",
    "HitsDevice",
    "KernelConfig",
    "compute_log_conprb",
    "compute_log_noise_conprb",
    "estep_fracs",
    "suffstats",
]
