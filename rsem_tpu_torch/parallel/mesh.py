"""Data-parallel EM over the ranks of a process group.

Counterpart of rsem_tpu/parallel/mesh.py. The reference parallelizes its
E-step with pthreads over read shards and a serial count-vector reduction
(EM.cpp:135-157, 373-389). The JAX package shards reads and hits over a
1-D device mesh, padded to common shapes, and psums the per-round
statistics inside shard_map. Here each rank holds one contiguous range of
reads, balanced by hits (a read's hits and a pair's mates never split),
as an AlignmentBundle of its own with no padding; transcript-sized state
(theta, the model, the reference) is whole on every rank.

The JAX package's sharded conprb, round and fused model loop
(`make_sharded_conprb`, `make_sharded_round`, `make_sharded_model_loop`)
are not separate functions here: engine/em.py runs the single-device
functions (ops/conprb, the per-round path, ops/model_loop.run_model_loop)
on the rank's slice and passes them the process group, which all-reduce
their counts and sufficient statistics where the JAX package psums.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np

from ..io.hits import HitArrays
from ..io.reads import PairedReadArrays, ReadArrays
from ..io.sam import AlignmentBundle
from .fast_sharded import partition_reads_by_hits


class ReadShard(NamedTuple):
    """One rank's reads and where every rank's lie."""

    bundle: AlignmentBundle  # the rank's reads, rid and offsets local
    bounds: np.ndarray  # [world+1] read cuts
    hit_bounds: np.ndarray  # [world+1] hit cuts

    @property
    def read_sizes(self):
        return np.diff(self.bounds).tolist()

    @property
    def hit_sizes(self):
        return np.diff(self.hit_bounds).tolist()


def _slice_reads(ra: ReadArrays, lo: int, hi: int) -> ReadArrays:
    return ReadArrays(codes=ra.codes[lo:hi], lens=ra.lens[lo:hi],
                      quals=None if ra.quals is None else ra.quals[lo:hi],
                      lq=ra.lq[lo:hi])


def shard_bundle_by_read(bundle: AlignmentBundle, n_shards: int,
                         shard: int) -> ReadShard:
    """Shard `shard` of `n_shards` contiguous read ranges balanced by hit
    count (EM.cpp:135-157): its reads and hits as an AlignmentBundle, rid
    rebased to the shard's first read and read_offsets to its first hit.
    The read statistics, counts and omitted sids stay the whole sample's
    (the model's initial estimate and theta's start need them)."""
    hits = bundle.hits
    offsets = np.asarray(hits.read_offsets, dtype=np.int64)
    bounds = partition_reads_by_hits(offsets, n_shards)
    hit_bounds = offsets[bounds]
    lo, hi = int(bounds[shard]), int(bounds[shard + 1])
    hlo, hhi = int(hit_bounds[shard]), int(hit_bounds[shard + 1])
    local_hits = HitArrays(
        rid=(hits.rid[hlo:hhi] - lo).astype(hits.rid.dtype),
        sid=hits.sid[hlo:hhi], dir=hits.dir[hlo:hhi],
        pos=hits.pos[hlo:hhi],
        insert_len=(None if hits.insert_len is None
                    else hits.insert_len[hlo:hhi]),
        read_offsets=(offsets[lo:hi + 1] - hlo).astype(
            hits.read_offsets.dtype))
    reads = bundle.reads
    if bundle.paired:
        local_reads = PairedReadArrays(_slice_reads(reads.mate1, lo, hi),
                                       _slice_reads(reads.mate2, lo, hi),
                                       reads.lq[lo:hi])
    else:
        local_reads = _slice_reads(reads, lo, hi)
    local = dataclasses.replace(bundle, reads=local_reads, hits=local_hits)
    return ReadShard(local, bounds, hit_bounds)
