"""Device-resident data layout for the quantification kernels.

Counterpart of rsem_tpu/ops/layout.py. The alignment problem is sparse and
ragged (1..200 alignments per read); on the GPU it stays in CSR form:

  RefDevice   concatenated transcript base codes + per-transcript metadata
  ReadsDevice [N, L] read codes/quals + lengths + low-quality flags
  HitsDevice  flat [H] hit arrays (rid/sid/dir/pos/insertL), rid sorted,
              plus the [N+1] read_offsets of the CSR

Unlike the TPU layout there are no padding rows (PyTorch runs eagerly, so
no shape needs to stay static).

The device cache. A repeat pass over the same host containers (a library
caller's second run_em on one bundle) reuses the device tensors of the
first instead of copying the layout again. Entries are keyed on the
container's id(), the device and the width, and evicted by a weakref
finalizer when the container is garbage-collected, as in the JAX package.
Each entry also keeps a fingerprint of the arrays it was built from: for
each array the layout reads, the object's identity, its buffer address,
shape, dtype and strides, and a checksum of a fixed strided sample of at
most FINGERPRINT_SAMPLE elements. A lookup whose fingerprint differs
(an attribute replaced, the array reallocated or a sampled element
edited) rebuilds the entry; it never serves the old tensors. An in-place
edit of an element outside the sample is not detected: the containers
are immutable by contract (refprep.Reference, io.ReadArrays,
io.HitArrays). No entry is made for the CPU, where torch.as_tensor
already shares the numpy buffer. Cached tensors hold device memory for as
long as their containers live; clear_device_cache() frees them. Nothing
in the port writes into a layout's tensors.

Every array a layout copies to the device counts its host bytes into the
`upload_bytes` counter (utils/timing), on the CPU too: a call the cache
serves counts none.
"""

from __future__ import annotations

import weakref
import zlib
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils.device import to_device
from ..utils.timing import count

# elements of each array checksummed by the cache's fingerprint
FINGERPRINT_SAMPLE = 4096

# id(host container) -> {"_wr": weakref, "_fp": fingerprint, key: layout}
_DEV_CACHE: dict = {}


def _array_print(a) -> Optional[tuple]:
    """(identity, buffer address, shape, dtype, strides, sample checksum)
    of one host array; None for an absent one."""
    if a is None:
        return None
    x = np.asarray(a)
    if x.size:
        idx = np.linspace(0, x.size - 1, min(x.size, FINGERPRINT_SAMPLE)
                          ).astype(np.int64)
        crc = zlib.crc32(x.flat[idx].tobytes())
    else:
        crc = 0
    return (id(a), x.__array_interface__["data"][0], x.shape, x.dtype.str,
            x.strides, crc)


def _up(x, device, dtype: torch.dtype) -> torch.Tensor:
    """One host array of a layout on the device."""
    t = to_device(x, device, dtype)
    count("upload_bytes", np.asarray(x).nbytes)
    return t


def _device_key(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _dev_cached(obj, key: tuple, device, arrays: Sequence,
                build: Callable[[], tuple]):
    """The layout `build()` makes of `obj` for (key, device), from the
    cache when `obj`'s `arrays` still carry the fingerprint taken when it
    was built; never cached on the CPU."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return build()
    k = id(obj)
    fp = tuple(_array_print(a) for a in arrays)
    entry = _DEV_CACHE.get(k)
    if entry is None or entry["_wr"]() is not obj:
        try:
            wr = weakref.ref(obj, lambda _, k=k: _DEV_CACHE.pop(k, None))
        except TypeError:  # not weak-referenceable
            return build()
        entry = _DEV_CACHE[k] = {"_wr": wr, "_fp": fp}
    elif entry["_fp"] != fp:  # changed since: drop every layout of it
        entry = _DEV_CACHE[k] = {"_wr": entry["_wr"], "_fp": fp}
    full = key + (_device_key(dev),)
    if full not in entry:
        entry[full] = build()
    return entry[full]


def clear_device_cache() -> None:
    """Drop every cached layout (the device memory is freed once no other
    reference holds the tensors)."""
    _DEV_CACHE.clear()


def device_cache_bytes() -> int:
    """Bytes of the tensors the cache holds."""
    return sum(t.numel() * t.element_size()
               for entry in list(_DEV_CACHE.values())
               for k, layout in list(entry.items()) if not isinstance(k, str)
               for t in layout if isinstance(t, torch.Tensor))


class RefDevice(NamedTuple):
    codes: torch.Tensor  # [T] uint8 concatenated (incl. poly(A))
    offsets: torch.Tensor  # [M+2] int64 start of each sid
    full_len: torch.Tensor  # [M+1] int32
    tot_len: torch.Tensor  # [M+1] int32
    mask_start: torch.Tensor  # [M+1] int32

    @classmethod
    def from_reference(cls, ref, device: torch.device) -> "RefDevice":
        """ref: refprep.Reference (cached per device)."""
        return _dev_cached(
            ref, ("ref",), device, (ref.codes, ref.offsets, ref.full_len,
                                    ref.tot_len, ref.mask_start),
            lambda: cls(
                codes=_up(ref.codes, device, torch.uint8),
                offsets=_up(ref.offsets, device, torch.int64),
                full_len=_up(ref.full_len, device, torch.int32),
                tot_len=_up(ref.tot_len, device, torch.int32),
                mask_start=_up(ref.mask_start, device, torch.int32),
            ))


class ReadsDevice(NamedTuple):
    codes: torch.Tensor  # [N, L] uint8
    lens: torch.Tensor  # [N] int32
    quals: Optional[torch.Tensor]  # [N, L] uint8 or None
    lq: torch.Tensor  # [N] bool

    @classmethod
    def from_arrays(cls, ra, device: torch.device,
                    width: Optional[int] = None) -> "ReadsDevice":
        """ra: io.ReadArrays; width: zero-pad the [N, L] arrays to this many
        columns (paired mates of different widths share one width).
        Cached per device and width."""
        def up(x, dt):
            t = _up(x, device, dt)
            if width is not None and t.dim() == 2 and t.shape[1] < width:
                t = torch.nn.functional.pad(t, (0, width - t.shape[1]))
            return t.contiguous()

        return _dev_cached(
            ra, ("reads", width), device, (ra.codes, ra.lens, ra.quals,
                                           ra.lq),
            lambda: cls(
                codes=up(ra.codes, torch.uint8),
                lens=up(ra.lens, torch.int32),
                quals=(up(ra.quals, torch.uint8) if ra.quals is not None
                       else None),
                lq=up(ra.lq, torch.bool),
            ))


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
        """ha: io.HitArrays (cached per device)."""
        return _dev_cached(
            ha, ("hits",), device, (ha.rid, ha.sid, ha.dir, ha.pos,
                                    ha.insert_len, ha.read_offsets),
            lambda: cls(
                rid=_up(ha.rid, device, torch.int32),
                sid=_up(ha.sid, device, torch.int32),
                dir=_up(ha.dir, device, torch.int32),
                pos=_up(ha.pos, device, torch.int32),
                insert_len=(_up(ha.insert_len, device, torch.int32)
                            if ha.insert_len is not None else None),
                read_offsets=_up(ha.read_offsets, device, torch.int64),
            ))


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
