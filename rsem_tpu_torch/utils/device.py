"""Device selection and host transfers for the PyTorch port.

Counterpart of rsem_tpu/utils/jaxinit.py. PyTorch needs no runtime
configuration (no x64 flag, no compilation cache), so what remains is:

* ``resolve_device(device)`` — the port's entry points run on CUDA unless
  the caller asks for the CPU. There is no silent CPU fallback: asking for
  CUDA (the default) on a machine without it raises.
* ``fetch64(t)``, ``fetch_list(t)`` — device tensor -> host float64 numpy
  array, or Python list: the port's host reads of device memory, each a
  wait for the device, counted (`d2h_reads`) and timed (span `rsem.sync`).
* ``to_device(x, device)`` — host array -> device tensor: the port's
  copies to the device. A copy from pageable host memory (as numpy's is)
  to a CUDA device returns only when it is done: each such wait is
  counted (`h2d_copies`).
* ``sync(device)`` — wait for the device's queued work (CUDA is
  asynchronous; a host clock around unsynchronised work measures enqueue).
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np
import torch

from .timing import count, span

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
    with span("rsem.sync"):
        count("d2h_reads")
        return t.detach().cpu().numpy().astype(np.float64, copy=False)


def fetch_list(t: torch.Tensor) -> List:
    """Tensor -> host Python list (Tensor.tolist)."""
    with span("rsem.sync"):
        count("d2h_reads")
        return t.tolist()


def copy_waits(device) -> bool:
    """Whether a copy of numpy (pageable) memory to `device` holds the
    host until it is done: on a CUDA device, PyTorch stages and finishes
    it before returning; on the CPU there is nothing to wait for."""
    return torch.device(device).type == "cuda"


def to_device(x, device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """Host array -> tensor on `device` (converted to `dtype` if given),
    counting the copy where the host waits for it; on the CPU it may
    share x's memory."""
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    if copy_waits(device):
        count("h2d_copies")
    return torch.as_tensor(a).to(device, dtype)


def sync(device: Optional[torch.device] = None) -> None:
    """Block until the device's queued work is done (no-op on the CPU)."""
    if device is None or torch.device(device).type == "cuda":
        if torch.cuda.is_available():
            torch.cuda.synchronize(device)
