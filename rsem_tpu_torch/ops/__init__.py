from .layout import (RefDevice, ReadsDevice, HitsDevice, KernelConfig,
                     clear_device_cache, device_cache_bytes)
from .conprb import compute_log_conprb, compute_log_noise_conprb
from .estep import estep_fracs, suffstats

__all__ = [
    "RefDevice",
    "ReadsDevice",
    "HitsDevice",
    "KernelConfig",
    "clear_device_cache",
    "device_cache_bytes",
    "compute_log_conprb",
    "compute_log_noise_conprb",
    "estep_fracs",
    "suffstats",
]
