"""The process group: one process per device, sums where the JAX package
psums.

Counterpart of rsem_tpu/parallel/distributed.py. The JAX package runs one
controller over a device mesh; PyTorch's idiom is SPMD: every process owns
one device, joins a `torch.distributed` process group, and the engines
all-reduce their partial sums (NCCL between CUDA ranks, gloo between CPU
ranks). Bring-up is triggered by the environment, so a single process
never pays for it:

  RSEM_TPU_COORDINATOR=host:port   rank 0's address (tcp:// rendezvous)
  RSEM_TPU_NUM_PROCESSES=N
  RSEM_TPU_PROCESS_ID=i
or
  RSEM_TPU_AUTO_DISTRIBUTED=1      env:// rendezvous from MASTER_ADDR,
                                   MASTER_PORT, RANK and WORLD_SIZE, as
                                   torchrun sets them

The backend is NCCL on CUDA and gloo on the CPU; `init_group` takes
another (gloo lets several ranks share one card, as chip_smoke.py's
phase 16b does). A rank's device is cuda:LOCAL_RANK, or cuda:(rank % device count) when
LOCAL_RANK is unset. The pipeline driver calls `maybe_initialize` at
entry; with the variables set and no group reachable it raises, and never
carries on as one process.

The collectives take the rank's tensors as they are: CUDA tensors under
NCCL, and under gloo CPU tensors or CUDA ones (the gloo of the H100
machine's torch takes CUDA tensors for every collective used here;
chip_smoke.py phase 16b runs them on the card), so nothing is staged
through host memory.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from ..utils.device import DeviceLike, resolve_device


@dataclass(frozen=True)
class Dist:
    """A formed process group and this process's place in it."""

    group: Any  # torch.distributed ProcessGroup
    rank: int
    world: int
    device: torch.device
    backend: str  # "nccl" or "gloo"

    @property
    def root(self) -> bool:
        return self.rank == 0


GROUP_TIMEOUT_S = 600.0  # rendezvous and collective timeout of the group

_handle: Optional[Dist] = None
_initialized = False


def is_distributed() -> bool:
    return tdist.is_available() and tdist.is_initialized() and \
        tdist.get_world_size() > 1


def _rank_device(device: DeviceLike, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_group(device: DeviceLike, init_method: str, world: int, rank: int,
               backend: Optional[str] = None,
               timeout_s: float = GROUP_TIMEOUT_S) -> Dist:
    """Form the default process group (or take the one this process
    formed) and return its handle; raises if it cannot be formed. backend
    None: nccl on CUDA, gloo on the CPU. One sum over the group runs before
    it returns, so an NCCL communicator exists (its creation syncs) before
    any sync-free loop."""
    dev = _rank_device(device, rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not tdist.is_initialized():
        tdist.init_process_group(backend, init_method=init_method,
                                 world_size=world, rank=rank,
                                 timeout=timedelta(seconds=timeout_s))
    if tdist.get_world_size() != world or tdist.get_rank() != rank:
        raise RuntimeError("the process group does not match "
                           f"rank {rank} of {world}")
    handle = Dist(tdist.group.WORLD, rank, world, dev, tdist.get_backend())
    all_reduce_(torch.zeros(1, device=dev), handle)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return handle


def maybe_initialize(device: DeviceLike = None) -> Optional[Dist]:
    """Join the process group the environment asks for (init_group); None
    when it asks for none. Idempotent: later calls return the first
    call's answer."""
    global _handle, _initialized
    if _initialized:
        return _handle
    coord = os.environ.get("RSEM_TPU_COORDINATOR")
    auto = os.environ.get("RSEM_TPU_AUTO_DISTRIBUTED") == "1"
    if coord:
        world = int(os.environ["RSEM_TPU_NUM_PROCESSES"])
        rank = int(os.environ["RSEM_TPU_PROCESS_ID"])
        init_method = f"tcp://{coord}"
    elif auto:
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = "env://"
    if coord or auto:
        _handle = init_group(device, init_method, world, rank,
                             timeout_s=GROUP_TIMEOUT_S)
    _initialized = True
    return _handle


def process_read_bounds(n_reads_or_offsets, n_processes: Optional[int] = None,
                        hit_balanced: bool = True) -> np.ndarray:
    """Which contiguous read range each process owns: [P+1] cuts. With
    plain `n_reads` the split is uniform; with the full read_offsets vector
    it is balanced by hits like the reference's thread partition
    (EM.cpp:135-157)."""
    from .fast_sharded import partition_reads_by_hits

    np_ = n_processes or (tdist.get_world_size()
                          if tdist.is_available() and tdist.is_initialized()
                          else 1)
    if np.ndim(n_reads_or_offsets) == 0:
        n = int(n_reads_or_offsets)
        return ((np.arange(np_ + 1) * n) // np_).astype(np.int64)
    if not hit_balanced:
        n = len(n_reads_or_offsets) - 1
        return ((np.arange(np_ + 1) * n) // np_).astype(np.int64)
    return partition_reads_by_hits(n_reads_or_offsets, np_)


# ------------------------------------------------------------------ #
# collectives                                                        #
# ------------------------------------------------------------------ #
def all_reduce_(t: torch.Tensor, d: Dist) -> torch.Tensor:
    """Sum of `t` over the ranks, in place (every rank gets the same
    bits). Asynchronous to the host under NCCL."""
    tdist.all_reduce(t, group=d.group)
    return t


def all_reduce_dict_(tensors: dict, d: Dist) -> dict:
    """Sum each tensor of `tensors` over the ranks with one all_reduce of
    one flat float64 buffer; the sums are written back in place, in each
    tensor's own dtype."""
    items = list(tensors.values())
    if not items:
        return tensors
    flat = torch.cat([v.reshape(-1).to(torch.float64) for v in items])
    all_reduce_(flat, d)
    i = 0
    for v in items:
        v.copy_(flat[i:i + v.numel()].view(v.shape))
        i += v.numel()
    return tensors


def gather_rows(local: torch.Tensor, sizes: Sequence[int], d: Dist
                ) -> torch.Tensor:
    """The ranks' blocks of rows, concatenated in rank order, on every
    rank: rank r contributes `local` with sizes[r] rows. One all_reduce of
    a zero-filled buffer (x + 0 = x, so the rows arrive exactly)."""
    sizes = [int(s) for s in sizes]
    if local.shape[0] != sizes[d.rank]:
        raise ValueError(f"rank {d.rank} holds {local.shape[0]} rows, "
                         f"not {sizes[d.rank]}")
    lo = sum(sizes[:d.rank])
    full = torch.zeros((sum(sizes), *local.shape[1:]), dtype=local.dtype,
                       device=local.device)
    full[lo:lo + sizes[d.rank]] = local
    return all_reduce_(full, d)


def on_root(fn: Callable[[], Any], d: Optional[Dist]) -> Any:
    """fn() on rank 0 alone (work that writes files); its result, or the
    error it raised, on every rank. Without a group, fn()."""
    if d is None:
        return fn()
    box = [None]
    if d.root:
        try:
            box[0] = (True, fn())
        except Exception as e:  # re-raised below, on every rank
            box[0] = (False, e)
    tdist.broadcast_object_list(box, src=0, group=d.group)
    ok, value = box[0]
    if ok:
        return value
    if d.root:
        raise value
    raise RuntimeError(f"rank 0 failed: {value!r}")
