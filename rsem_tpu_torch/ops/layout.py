"""Device-resident data layout for the quantification kernels.

Counterpart of rsem_tpu/ops/layout.py. The alignment problem is sparse and
ragged (1..200 alignments per read); on the GPU it stays in CSR form:

  RefDevice   concatenated transcript base codes + per-transcript metadata
  ReadsDevice [N, L] read codes/quals + lengths + low-quality flags
  HitsDevice  flat [H] hit arrays (rid/sid/dir/pos/insertL), rid sorted,
              plus the [N+1] read_offsets of the CSR

Unlike the TPU layout there are no padding rows (PyTorch runs eagerly, so
no shape needs to stay static) and no device cache keyed by host object id:
each call uploads what it is given.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class RefDevice(NamedTuple):
    codes: torch.Tensor  # [T] uint8 concatenated (incl. poly(A))
    offsets: torch.Tensor  # [M+2] int64 start of each sid
    full_len: torch.Tensor  # [M+1] int32
    tot_len: torch.Tensor  # [M+1] int32
    mask_start: torch.Tensor  # [M+1] int32

    @classmethod
    def from_reference(cls, ref, device: torch.device) -> "RefDevice":
        """ref: refprep.Reference."""
        def up(x, dt):
            return torch.as_tensor(np.ascontiguousarray(x)).to(device, dt)

        return cls(
            codes=up(ref.codes, torch.uint8),
            offsets=up(ref.offsets, torch.int64),
            full_len=up(ref.full_len, torch.int32),
            tot_len=up(ref.tot_len, torch.int32),
            mask_start=up(ref.mask_start, torch.int32),
        )


class ReadsDevice(NamedTuple):
    codes: torch.Tensor  # [N, L] uint8
    lens: torch.Tensor  # [N] int32
    quals: Optional[torch.Tensor]  # [N, L] uint8 or None
    lq: torch.Tensor  # [N] bool

    @classmethod
    def from_arrays(cls, ra, device: torch.device,
                    width: Optional[int] = None) -> "ReadsDevice":
        """ra: io.ReadArrays; width: zero-pad the [N, L] arrays to this many
        columns (paired mates of different widths share one width)."""
        def up(x, dt):
            t = torch.as_tensor(np.ascontiguousarray(x)).to(device, dt)
            if width is not None and t.dim() == 2 and t.shape[1] < width:
                t = torch.nn.functional.pad(t, (0, width - t.shape[1]))
            return t.contiguous()

        return cls(
            codes=up(ra.codes, torch.uint8),
            lens=up(ra.lens, torch.int32),
            quals=up(ra.quals, torch.uint8) if ra.quals is not None else None,
            lq=up(ra.lq, torch.bool),
        )


class HitsDevice(NamedTuple):
    rid: torch.Tensor  # [H] int32 (sorted)
    sid: torch.Tensor  # [H] int32 >= 1
    dir: torch.Tensor  # [H] int32 0/1
    pos: torch.Tensor  # [H] int32
    insert_len: Optional[torch.Tensor]  # [H] int32 (paired)
    read_offsets: torch.Tensor  # [N+1] int64

    @property
    def n_hits(self) -> int:
        return int(self.rid.shape[0])

    @property
    def n_reads(self) -> int:
        return int(self.read_offsets.shape[0]) - 1

    @classmethod
    def from_arrays(cls, ha, device: torch.device) -> "HitsDevice":
        def up(x, dt):
            return torch.as_tensor(np.ascontiguousarray(x)).to(device, dt)

        return cls(
            rid=up(ha.rid, torch.int32),
            sid=up(ha.sid, torch.int32),
            dir=up(ha.dir, torch.int32),
            pos=up(ha.pos, torch.int32),
            insert_len=(up(ha.insert_len, torch.int32)
                        if ha.insert_len is not None else None),
            read_offsets=up(ha.read_offsets, torch.int64),
        )


class KernelConfig(NamedTuple):
    """Static configuration of the conprb/suffstat passes."""

    paired: bool
    has_qual: bool
    est_rspd: bool
    use_mld: bool  # mld exists (paired always; single iff mean given)
    B: int
    seed_len: int
    gld_lb: int
    gld_ub: int
    mld_lb: int
    mld_ub: int
    max_read_len: int  # L of the read arrays
    pro_len: int  # profile position axis (maxL for Profile, 100 for QProfile)
    # effective key-space bounds for the PreIdx tables: with quals the
    # profile key (q*5+ref)*5+read never exceeds (qmax+1)*25, without quals
    # it never exceeds read_len*25. 0 = full table (qmax unknown).
    pro_key_size: int = 0
    npro_key_size: int = 0

    def pro_keys(self) -> int:
        return self.pro_key_size or self.pro_len * 25

    def npro_keys(self) -> int:
        full = 500 if self.has_qual else 5
        return min(self.npro_key_size, full) if self.npro_key_size else full

    @classmethod
    def from_model(cls, model, max_read_len: int,
                   qmax: int = None) -> "KernelConfig":
        """qmax: max quality code present in the reads (host numpy max);
        None leaves the full key space (no windowing)."""
        spec = model.spec
        glb, gub = model.gld_window
        mlb, mub = model.mld_window if model.mld_window else (0, 1)
        if spec.has_qual:
            pro_keys = 25 * (qmax + 1) if qmax is not None else 0
            npro_keys = 5 * (qmax + 1) if qmax is not None else 0
        else:
            pro_keys = 25 * max_read_len
            npro_keys = 0
        pro_len = 100 if spec.has_qual else model.pro.pro_len
        return cls(
            paired=spec.paired,
            has_qual=spec.has_qual,
            est_rspd=spec.est_rspd,
            use_mld=spec.has_mld,
            B=spec.B,
            seed_len=spec.seed_len,
            gld_lb=glb,
            gld_ub=gub,
            mld_lb=mlb,
            mld_ub=mub,
            max_read_len=max_read_len,
            pro_len=pro_len,
            pro_key_size=min(pro_keys, pro_len * 25),
            npro_key_size=npro_keys,
        )
