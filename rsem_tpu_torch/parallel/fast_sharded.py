"""Read-sharded theta-only EM loop over the ranks of a process group.

Counterpart of rsem_tpu/parallel/fast_sharded.py. The reference
parallelizes exactly this loop (the cached-conprb E-step rounds that
dominate EM wall time) with pthreads over read shards and a serial
reduction (EM.cpp:135-157,373-398). Here each rank holds one contiguous
range of reads (and their hits) and runs kernel K1 on its own CSR; each
round is K1's partial kernel, one all_reduce of [contrib | noise sum]
((M+2) doubles, ~160 KB at M = 20,000), then K1's counts and M-step
kernels on the sums, n0 added once. Every rank then holds the same theta
and the same stop counts, so all stop at the same round. The loop keeps
ops/theta.run_theta_loop's segments: no host read inside a segment.

The same read partition cuts the host-resident chunks of the streamed
theta loop (build_theta_chunks, ops/theta.run_theta_loop_streamed).

The JAX bucket tiles and the padding of every shard (and chunk) to common
shapes were there for shard_map and one jit signature; the port has no use
for them.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..constants import MAX_ROUND, MIN_ROUND
from ..ops import theta as theta_ops
from ..ops.gibbs import scale_conprbs
from ..ops.theta import RoundState, ThetaData
from ..utils.device import DeviceLike, resolve_device
from .distributed import Dist, all_reduce_, gather_rows


def partition_reads_by_hits(offsets: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous read partition balanced by cumulative hit count — the
    reference's thread partitioning strategy (EM.cpp:135-157)."""
    n_reads = len(offsets) - 1
    total = int(offsets[-1])
    targets = (np.arange(1, n_shards) * total) // n_shards
    cuts = np.searchsorted(offsets[1:], targets, side="left") + 1
    cuts = np.minimum(cuts, n_reads)
    return np.concatenate([[0], cuts, [n_reads]]).astype(np.int64)


def build_theta_chunks(
    hits, log_conprb: np.ndarray, log_ncp: np.ndarray, M: int, n0: float,
    n_chunks: int, device: DeviceLike = None,
) -> Tuple[List[ThetaData], np.ndarray, np.ndarray]:
    """Host chunks of the streamed theta loop (counterpart of
    rsem_tpu/parallel/fast_sharded.py build_fast_data_chunks): reads cut
    by partition_reads_by_hits into n_chunks contiguous ranges. Each chunk
    is a ThetaData of CPU tensors: sid and rid int32 (rid local to the
    chunk), cps and ncs f32 scaled per read in f64 (ops/gibbs.
    scale_conprbs), read_offsets int64 from 0. For a CUDA device (the
    default) the tensors are pinned, which raises where it cannot be
    done. Returns (chunks, read bounds [n_chunks+1], hit bounds)."""
    dev = resolve_device(device)
    offs = np.asarray(hits.read_offsets, dtype=np.int64)
    bounds = partition_reads_by_hits(offs, n_chunks)
    hit_bounds = offs[bounds]
    cps, ncs = scale_conprbs(hits, log_conprb, log_ncp)

    def host(x: np.ndarray, dt) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x, dtype=dt))
        return t.pin_memory() if dev.type == "cuda" else t

    chunks = []
    for lo, hi, hlo, hhi in zip(bounds[:-1], bounds[1:], hit_bounds[:-1],
                                hit_bounds[1:]):
        chunks.append(ThetaData(
            sid=host(hits.sid[hlo:hhi], np.int32),
            rid=host(np.asarray(hits.rid[hlo:hhi], dtype=np.int64) - lo,
                     np.int32),
            cps=host(cps[hlo:hhi], np.float32),
            ncs=host(ncs[lo:hi], np.float32),
            read_offsets=host(offs[lo:hi + 1] - hlo, np.int64),
            M=M, n0=float(n0)))
    return chunks, bounds, hit_bounds


def sharded_rounds(state: RoundState, data: ThetaData, n: int,
                   dist: Dist) -> None:
    """Enqueue n read-sharded rounds from state.ring[0]: K1's partial on
    this rank's reads, the sum over the ranks, K1's finish."""
    for i in range(n):
        theta_ops.theta_partial(state, data, i)
        all_reduce_(state.reduced, dist)
        theta_ops.theta_finish(state, data, i)


def run_theta_loop_sharded(theta0: torch.Tensor, data: ThetaData, dist: Dist,
                           min_round: int = MIN_ROUND,
                           max_round: int = MAX_ROUND,
                           start_round: int = 0) -> Tuple[torch.Tensor, int]:
    """run_theta_loop over read shards: `data` is this rank's reads;
    returns (theta, rounds), the same on every rank."""
    return theta_ops.run_theta_loop(
        theta0, data, min_round, max_round, start_round,
        rounds_fn=lambda st, d, n: sharded_rounds(st, d, n, dist))


def counts_sharded(theta: torch.Tensor, data: ThetaData, dist: Dist
                   ) -> torch.Tensor:
    """The f64 [M+1] expected counts over all ranks' reads at a fixed
    theta (counts[0] includes n0 once): one sharded round."""
    state = theta_ops.round_state(data, 1, theta.device)
    state.ring[0] = theta
    sharded_rounds(state, data, 1, dist)
    return state.counts


def final_fracs_sharded(theta: torch.Tensor, data: ThetaData, dist: Dist,
                        hit_sizes: Sequence[int], read_sizes: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final posterior responsibilities (EM.cpp:460-478) of every rank's
    hits and reads, in the global hit and read order, on every rank."""
    fh, fn = theta_ops.final_fracs(theta, data)
    return gather_rows(fh, hit_sizes, dist), gather_rows(fn, read_sizes,
                                                         dist)
