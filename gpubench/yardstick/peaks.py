"""Published peaks of the card and the least time a piece of work can take.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at the full 700 W
power limit: 3.35 TB/s of HBM3 bandwidth and 67 TFLOP/s of float32 outside
the tensor cores (the kernels of this program run no tensor-core math). A
frozen copy of the `bound()` arithmetic of the port's `chip_smoke.py`.
"""

from __future__ import annotations

from typing import Dict

H100_SXM = {
    "name": "NVIDIA H100 SXM (data sheet)",
    "hbm_bytes_per_s": 3.35e12,
    "fp32_flop_per_s": 67e12,
    "power_limit_w": 700.0,
}


def least_seconds(bytes_moved: float, flops: float,
                  peaks: Dict = H100_SXM) -> float:
    """max(bytes / bandwidth, operations / float32 rate): the time the card
    needs at least for work that reads and writes `bytes_moved` once and
    computes `flops`."""
    return max(bytes_moved / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flop_per_s"])

