"""Device selection and host transfers for the PyTorch port.

Counterpart of rsem_tpu/utils/jaxinit.py. PyTorch needs no runtime
configuration (no x64 flag, no compilation cache), so what remains is:

* ``resolve_device(device)`` — the port's entry points run on CUDA unless
  the caller asks for the CPU. There is no silent CPU fallback: asking for
  CUDA (the default) on a machine without it raises.
* ``fetch64(t)`` — device tensor -> host float64 numpy array.
* ``sync(device)`` — wait for the device's queued work (CUDA is
  asynchronous; a host clock around unsynchronised work measures enqueue).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` or the default "cuda"; raises if CUDA is asked for and
    absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def fetch64(t: torch.Tensor) -> np.ndarray:
    """Tensor -> host float64 numpy (moves the native dtype, widens on the
    host)."""
    return t.detach().cpu().numpy().astype(np.float64, copy=False)


def sync(device: Optional[torch.device] = None) -> None:
    """Block until the device's queued work is done (no-op on the CPU)."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)
