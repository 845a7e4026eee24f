"""Small-table gather-sum (K2) and scatter-add (K3) over PreIdx rows.

Counterpart of rsem_tpu/ops/pallas_table.py. The model-update rounds look
up and accumulate ~250M (hit, position) entries of a table of at most a
few thousand slots per pass. Index layout (ops/conprb.PreIdx): [rows, cols]
int32, cols a multiple of 128; lanes past a read's length and the pad
columns carry a SENTINEL slot = the table size, which gathers 0 and
scatters nowhere.

Each function has its CUDA kernel (csrc/table.cu) and, beside it, a plain
PyTorch version. A CPU tensor takes the plain version; a CUDA tensor
launches the kernel (or raises) and bumps the wrapper's `launches` count.
`onehot_scatter` of the TPU package has no counterpart: every count vector
is a plain `index_add_` here.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build


def _check_idx(idx: torch.Tensor) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 2 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous [rows, cols] int32 tensor")
    if idx.shape[1] % 4:
        raise ValueError("idx columns must be a multiple of 4")


def padded_table(values_flat: torch.Tensor, size: int) -> torch.Tensor:
    """f32 [size + 1]: the first `size` values and a zero sentinel slot."""
    t = torch.zeros(size + 1, dtype=torch.float32, device=values_flat.device)
    t[:size] = values_flat[:size].to(torch.float32)
    return t


def gather_sum_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32 [rows]: sum_c table[idx[r, c]], summed in f64 like the kernel."""
    return table[idx.long()].sum(1, dtype=torch.float64).to(torch.float32)


def gather_sum(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """f32 [rows]: per-row sum of table[idx[r, :]].

    table: f32 [T] (index T-1 is the zero sentinel, see padded_table);
    idx: [rows, cols] int32 with every entry < T."""
    _check_idx(idx)
    if table.dtype != torch.float32 or table.dim() != 1:
        raise ValueError("table must be a 1-D float32 tensor")
    if table.device != idx.device:
        raise ValueError("table and idx must be on one device")
    if idx.device.type == "cpu":
        return gather_sum_plain(table, idx)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    table = table.contiguous()
    rows, cols = idx.shape
    out = torch.empty(rows, dtype=torch.float32, device=idx.device)
    _build.check(_build.lib().rsem_gather_sum(
        table.data_ptr(), table.numel(), idx.data_ptr(), rows, cols,
        out.data_ptr(), _build.stream_of(idx)), "gather_sum")
    gather_sum.launches += 1
    return out


gather_sum.launches = 0


def scatter_add_plain(idx: torch.Tensor, w: torch.Tensor, size: int,
                      acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 [size]: f64 index_add_ of each row's weight over its indices
    (sentinels land in slot `size`, which is cut off); with `acc`, added
    into that f64 [size] table, which is returned."""
    full = torch.zeros(size + 1, dtype=torch.float64, device=idx.device)
    full.index_add_(0, idx.reshape(-1).long().clamp(max=size),
                    w.double().repeat_interleave(idx.shape[1]))
    if acc is not None:
        return acc.add_(full[:size])
    return full[:size].to(torch.float32)


def scatter_add(idx: torch.Tensor, w: torch.Tensor, size: int,
                acc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """f32 [size]: counts[t] += w[r] for every idx[r, c] == t < size.

    idx: [rows, cols] int32; w: f32 [rows] per-ROW weight (broadcast across
    the row's columns). Indices >= size (sentinels) are dropped, and rows
    of weight 0 are skipped. acc: a float64 [size] table that the counts
    are added into and that is returned (the fused loop's rounds and the
    passes over a windowed PreIdx keep theirs, so their launches allocate
    nothing); without it the counts come back as float32. Tables of more
    than 58,112 slots (227 KB of f32) are refused on CUDA."""
    _check_idx(idx)
    if w.dtype != torch.float32 or w.shape != (idx.shape[0],):
        raise ValueError("w must be float32 [rows]")
    if w.device != idx.device:
        raise ValueError("idx and w must be on one device")
    if acc is not None and (acc.dtype != torch.float64 or acc.shape != (
            size,) or acc.device != idx.device or not acc.is_contiguous()):
        raise ValueError("acc must be a contiguous float64 [size] tensor on "
                         "idx's device")
    if idx.device.type == "cpu":
        return scatter_add_plain(idx, w, size, acc)
    if idx.device.type != "cuda":
        raise ValueError(f"unsupported device {idx.device}")
    w = w.contiguous()
    rows, cols = idx.shape
    out = acc if acc is not None else torch.zeros(
        size, dtype=torch.float64, device=idx.device)
    _build.check(_build.lib().rsem_scatter_add(
        idx.data_ptr(), rows, cols, w.data_ptr(), size, out.data_ptr(),
        _build.stream_of(idx)), "scatter_add")
    scatter_add.launches += 1
    return out if acc is not None else out.to(torch.float32)


scatter_add.launches = 0
