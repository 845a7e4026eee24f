"""Theta-only EM rounds over frozen conprbs (kernel K1) and their loop.

Counterpart of rsem_tpu/ops/pallas_round.py and rsem_tpu/ops/fast_estep.py
(and of ops/ddsum.py, which is not needed: f64 is native on the GPU).
After the model-update rounds the conprbs are frozen and scaled per read
by their max (so linear f32 never underflows); each round is then

    counts_m = theta_m * sum_{hits h of m} cps_h / denom(read of h)
    counts_0 = noise + n0;   theta_new = counts / sum(counts)

with denom(r) = sum_h theta[sid_h] * cps_h + theta_0 * ncs_r (EM.cpp:
199-244 over cached conprbs, 385-398), followed by the stop test's count
of entries still moving (EM.cpp:407-416). The hits stay in CSR order by
read_offsets: no K-buckets, no M cap, no quarter-power-of-2 shape menus.
theta stays float32 between rounds, as in the TPU loop; the sums and the
M-step run in f64.

The loop keeps its rounds on the device, as the JAX package's while_loop
does: it enqueues SEGMENT rounds (M-step and stop count included) into
buffers allocated once per loop, then reads the segment's stop counts
with one host read and takes the first round at which the reference rule
stops; rounds computed past it are discarded.

A read-sharded round (parallel/fast_sharded.py) is the same round cut in
two around the sum over ranks: `theta_partial` (each rank's reads) and
`theta_finish` (counts, M-step and stop count on the summed partials).
The streamed loop (`run_theta_loop_streamed`) cuts it the same way over
chunks of reads that stay in host memory: one partial per chunk, copied
to the card while the partial before it runs, then one finish.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import MAX_ROUND, MIN_ROUND, STOP_CRITERIA, THETA_CUT
from ..utils.device import DeviceLike, fetch_list, resolve_device
from . import _build
from .layout import HitsDevice

# Rounds enqueued between two host reads of the stop counts. Each read
# idles the card for a host round trip; each segment may compute up to
# SEGMENT - 1 rounds past the stop. Chosen from the 500-round loop on the
# H100 (chip_smoke.py phase 3 times S = 1, 16, 32 and 64; PERF.md).
SEGMENT = 32

# Rounds per host read in the streamed loop. A streamed round copies the
# whole dataset over the host link (tens of ms at a real sample's size),
# against which one host read per round is negligible; so no round runs
# past the stop, and the last round's counts are the stop round's.
STREAM_SEGMENT = 1


class ThetaData(NamedTuple):
    """Frozen per-dataset tensors of the theta loop (one device)."""

    sid: torch.Tensor  # [H] int32
    rid: torch.Tensor  # [H] int32, sorted
    cps: torch.Tensor  # [H] f32 conprb scaled by its read's max
    ncs: torch.Tensor  # [N] f32 noise conprb scaled alike
    read_offsets: torch.Tensor  # [N+1] int64
    M: int
    n0: float


def scale_conprbs(hits: HitsDevice, log_conprb: torch.Tensor,
                  log_ncp: torch.Tensor, M: int, n0: float) -> ThetaData:
    """Freeze: per-read max-logit scaling on the device (in f64; the scale
    cancels in every round)."""
    rid = hits.rid.long()
    lcp = log_conprb.double()
    lnp = log_ncp.double()
    read_max = torch.full_like(lnp, float("-inf"))
    read_max.scatter_reduce_(0, rid, lcp, "amax", include_self=True)
    read_max = torch.maximum(read_max, lnp)
    safe = torch.where(torch.isfinite(read_max), read_max,
                       torch.zeros_like(read_max))
    cps = torch.exp(lcp - safe[rid])
    ncs = torch.exp(lnp - safe)
    cps = torch.where(torch.isfinite(lcp), cps, torch.zeros_like(cps))
    ncs = torch.where(torch.isfinite(lnp), ncs, torch.zeros_like(ncs))
    return ThetaData(sid=hits.sid, rid=hits.rid,
                     cps=cps.float().contiguous(),
                     ncs=ncs.float().contiguous(),
                     read_offsets=hits.read_offsets, M=M, n0=float(n0))


def _weights(theta: torch.Tensor, data: ThetaData):
    """Per hit w = theta[sid]*cps, per read w0 = theta_0*ncs and the
    inverse denominator 1/(sum w + w0) (0 where the denominator is 0)."""
    w = theta[data.sid.long()] * data.cps
    d = torch.zeros_like(data.ncs).index_add_(0, data.rid, w)
    w0 = theta[0] * data.ncs
    denom = d + w0
    inv = torch.where(denom > 0, 1.0 / torch.where(denom > 0, denom,
                                                    torch.ones_like(denom)),
                      torch.zeros_like(denom))
    return w, w0, inv


def n_unconverged(theta_new: torch.Tensor, theta: torch.Tensor
                  ) -> torch.Tensor:
    """Entries of theta >= THETA_CUT whose relative change is still >=
    STOP_CRITERIA (EM.cpp:407-416), in float32 as the TPU loop does; an
    int32 scalar tensor on theta's device."""
    mask = theta >= THETA_CUT
    rel = (theta_new - theta).abs() / torch.where(mask, theta,
                                                   torch.ones_like(theta))
    change = torch.where(mask, rel, torch.zeros_like(rel))
    return (change >= STOP_CRITERIA).sum().int()


def theta_partial_plain(theta: torch.Tensor, data: ThetaData
                        ) -> torch.Tensor:
    """Plain version of K1's partial round over `data`'s reads: f64
    [M+2], contrib_m = sum_{hits h of m} cps_h * inv_{read of h} in
    [:M+1] (slot 0 unused) and the noise sum in [M+1]."""
    _w, w0, inv = _weights(theta, data)
    red = torch.zeros(data.M + 2, dtype=torch.float64, device=theta.device)
    red.index_add_(0, data.sid.long(), (data.cps * inv[data.rid]).double())
    red[data.M + 1] = (w0 * inv).double().sum()
    return red


def theta_finish_plain(theta: torch.Tensor, red: torch.Tensor, n0: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K1's finish on the partial sums `red` (f64 [M+2],
    summed over the ranks): (theta_new, counts, stop count) as
    theta_round_plain returns them."""
    M1 = theta.shape[0]
    c = red[:M1] * theta.double()
    c[0] = red[M1] + n0
    theta_new = (c / c.sum()).to(torch.float32)
    return theta_new, c, n_unconverged(theta_new, theta)


def theta_round_plain(theta: torch.Tensor, data: ThetaData
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1, one whole round: (theta_new f32 [M+1],
    counts f64 [M+1] with counts[0] = noise + n0, stop count int32)."""
    return theta_finish_plain(theta, theta_partial_plain(theta, data),
                              data.n0)


class RoundState(NamedTuple):
    """Device buffers of a run of rounds, allocated once and reused by
    every round: round i reads ring[i] and writes ring[i+1], counts and
    tot[i]. contrib and acc are views of one f64 buffer, so that the
    partial sums of a sharded round, [contrib | acc[0]] = `reduced`, are
    one contiguous [M+2] for one all_reduce."""

    ring: torch.Tensor  # [S+1, M+1] f32 theta ring
    counts: torch.Tensor  # [M+1] f64, the last round's counts
    tot: torch.Tensor  # [S] int32 stop counts
    contrib: torch.Tensor  # [M+1] f64 kernel scratch, kept zero
    acc: torch.Tensor  # [2] f64 kernel scratch (noise sum, total)
    reduced: torch.Tensor  # [M+2] f64 view: contrib, then acc[0]


def round_state(data: ThetaData, segment: int,
                device: torch.device) -> RoundState:
    M1 = data.M + 1
    scratch = torch.zeros(M1 + 2, dtype=torch.float64, device=device)
    return RoundState(
        ring=torch.empty((segment + 1, M1), dtype=torch.float32,
                         device=device),
        counts=torch.empty(M1, dtype=torch.float64, device=device),
        tot=torch.empty(segment, dtype=torch.int32, device=device),
        contrib=scratch[:M1], acc=scratch[M1:], reduced=scratch[:M1 + 1])


def theta_round(state: RoundState, data: ThetaData, n_rounds: int = 1
                ) -> None:
    """K1: n_rounds rounds from state.ring[0], written into state (one
    launch of the kernel sequence per round, all enqueued by one call).
    CPU tensors run theta_round_plain."""
    ring = state.ring
    if ring.dtype != torch.float32 or ring.dim() != 2 or \
            ring.shape[1] != data.M + 1 or not 1 <= n_rounds < ring.shape[0] \
            or state.tot.shape[0] < n_rounds:
        raise ValueError("theta ring must be float32 [>= n_rounds + 1, M+1]"
                         " with n_rounds >= 1 stop-count slots")
    dev = ring.device
    if dev.type == "cpu":
        for i in range(n_rounds):
            t, c, n = theta_round_plain(ring[i], data)
            ring[i + 1] = t
            state.counts.copy_(c)
            state.tot[i] = n
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_cuda_round(state, data)
    _build.check(_build.lib().rsem_theta_rounds(
        data.sid.data_ptr(), data.rid.data_ptr(), data.cps.data_ptr(),
        data.ncs.data_ptr(), data.read_offsets.data_ptr(),
        data.ncs.shape[0], data.M + 1, data.n0, ring.data_ptr(),
        state.counts.data_ptr(), state.tot.data_ptr(),
        state.contrib.data_ptr(), state.acc.data_ptr(), n_rounds,
        _build.stream_of(ring)), "theta_round")
    theta_round.launches += n_rounds


theta_round.launches = 0


def _check_cuda_round(state: RoundState, data: ThetaData) -> None:
    dev = state.ring.device
    for t in (data.sid, data.rid, data.cps, data.ncs, data.read_offsets,
              *state):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("theta-round inputs must be contiguous, on one "
                             "device")
    if data.sid.dtype != torch.int32 or data.rid.dtype != torch.int32:
        raise ValueError("sid and rid must be int32")


def theta_partial(state: RoundState, data: ThetaData, i: int) -> None:
    """K1's first kernel for round i on `data`'s reads (a rank's): adds
    the partial sums into state.reduced (left zero by the last finish) and
    zeroes the total and tot[i]. CPU tensors run theta_partial_plain."""
    dev = state.ring.device
    if dev.type == "cpu":
        state.reduced.add_(theta_partial_plain(state.ring[i], data))
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_cuda_round(state, data)
    _build.check(_build.lib().rsem_theta_partial(
        data.sid.data_ptr(), data.rid.data_ptr(), data.cps.data_ptr(),
        data.ncs.data_ptr(), data.read_offsets.data_ptr(),
        data.ncs.shape[0], state.ring[i].data_ptr(),
        state.contrib.data_ptr(), state.acc.data_ptr(),
        state.tot[i].data_ptr(), _build.stream_of(state.ring)),
        "theta_partial")
    theta_partial.launches += 1


theta_partial.launches = 0


def theta_finish(state: RoundState, data: ThetaData, i: int) -> None:
    """K1's counts and M-step kernels for round i on the summed
    state.reduced: writes ring[i+1], counts and tot[i], and leaves
    state.reduced zero. CPU tensors run theta_finish_plain."""
    dev = state.ring.device
    if dev.type == "cpu":
        t, c, n = theta_finish_plain(state.ring[i], state.reduced, data.n0)
        state.ring[i + 1] = t
        state.counts.copy_(c)
        state.tot[i] = n
        state.reduced.zero_()
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_cuda_round(state, data)
    _build.check(_build.lib().rsem_theta_finish(
        data.M + 1, data.n0, state.ring[i].data_ptr(),
        state.ring[i + 1].data_ptr(), state.counts.data_ptr(),
        state.tot[i].data_ptr(), state.contrib.data_ptr(),
        state.acc.data_ptr(), _build.stream_of(state.ring)),
        "theta_finish")
    theta_finish.launches += 1


theta_finish.launches = 0


def counts(theta: torch.Tensor, data: ThetaData) -> torch.Tensor:
    """f64 [M+1] expected counts at a fixed theta (counts[0] includes
    n0): the reference's final E-step (EM.cpp:460-478) reduced to the
    count vector, as one round of K1."""
    state = round_state(data, 1, theta.device)
    state.ring[0] = theta
    theta_round(state, data, 1)
    return state.counts


def _segment_length(rounds: int, min_round: int, max_round: int,
                    segment: int) -> int:
    """Rounds to enqueue next: at most `segment`, never past the round at
    which the rule must stop, and ending at min_round if it lies ahead
    (no stop can come earlier, so no round is computed in vain there)."""
    n = min(segment, max(min_round, max_round) - rounds)
    if rounds < min_round:
        n = min(n, min_round - rounds)
    return n


def _first_stop(rounds: int, tot: List[int], min_round: int,
                max_round: int) -> int:
    """Index in the segment of the round after which the reference loop
    (`while rounds < min_round or (tot > 0 and rounds < max_round)`) stops,
    or -1."""
    for i, t in enumerate(tot):
        r = rounds + i + 1
        if r >= min_round and (t == 0 or r >= max_round):
            return i
    return -1


def run_theta_loop(theta0: torch.Tensor, data: ThetaData,
                   min_round: int = MIN_ROUND, max_round: int = MAX_ROUND,
                   start_round: int = 0,
                   rounds_fn: Callable[[RoundState, ThetaData, int], None]
                   = theta_round, segment: Optional[int] = None,
                   progress: Optional[Callable[[int, int], None]] = None
                   ) -> Tuple[torch.Tensor, int]:
    """The reference's convergence rule (EM.cpp:53-55,407-416): at least
    min_round and at most max_round rounds in total, stopping at the first
    round after which every theta >= THETA_CUT moved by < STOP_CRITERIA.
    Rounds run `segment` (default SEGMENT) at a time, one host read per
    segment; rounds_fn enqueues n rounds into the state (theta_round; the
    read-sharded and streamed loops pass their own). progress(round, stop
    count) is called for every round up to the stop."""
    segment = segment or SEGMENT
    theta = theta0.to(torch.float32)
    rounds = start_round
    if rounds >= min_round and rounds >= max_round:
        return theta, rounds
    state = round_state(data, segment, theta.device)
    state.ring[0] = theta
    while True:
        n = _segment_length(rounds, min_round, max_round, segment)
        rounds_fn(state, data, n)
        tot = fetch_list(state.tot[:n])
        stop = _first_stop(rounds, tot, min_round, max_round)
        if progress is not None:
            for i in range(stop + 1 if stop >= 0 else n):
                progress(rounds + i + 1, tot[i])
        if stop >= 0:
            return state.ring[stop + 1].clone(), rounds + stop + 1
        rounds += n
        state.ring[0] = state.ring[n]


_CHUNK_FIELDS = ("sid", "rid", "cps", "ncs", "read_offsets")


class ChunkStream:
    """The rounds of the streamed loop over host chunks of reads (each a
    ThetaData with rid and read_offsets local to it). On the card, two
    device buffers, each the size of the largest chunk, are fed from the
    pinned chunks on a side stream, in turns: the copy of the next chunk
    runs while K1's partial reads the current one. Event `copied[b]`
    orders a partial after the copy into buffer b, event `read[b]` the
    next copy into b after the partial that read it. On the CPU the plain
    partial reads the chunks in place. `data` carries M and n0 to the
    finish."""

    def __init__(self, chunks: Sequence[ThetaData], M: int, n0: float,
                 dev: torch.device):
        self.chunks = [c for c in chunks if c.ncs.shape[0] > 0]
        if not self.chunks:
            raise ValueError("no chunk holds a read")
        for c in chunks:
            if c.M != M:
                raise ValueError(f"a chunk has M = {c.M}, not {M}")
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        self.data = ThetaData(
            sid=empty, rid=empty, cps=empty.float(), ncs=empty.float(),
            read_offsets=torch.zeros(1, dtype=torch.int64, device=dev),
            M=M, n0=float(n0))
        self.state: Optional[RoundState] = None  # the last rounds' state
        self.cuda = dev.type == "cuda"
        if not self.cuda:
            return
        for c in self.chunks:
            for f in _CHUNK_FIELDS:
                t = getattr(c, f)
                if t.device.type != "cpu" or not t.is_pinned():
                    raise ValueError(
                        "streamed chunks must be in pinned host memory "
                        "(parallel.fast_sharded.build_theta_chunks with a "
                        "CUDA device)")
        hmax = max(c.sid.shape[0] for c in self.chunks)
        nmax = max(c.ncs.shape[0] for c in self.chunks)
        self.bufs = [dict(
            sid=torch.empty(hmax, dtype=torch.int32, device=dev),
            rid=torch.empty(hmax, dtype=torch.int32, device=dev),
            cps=torch.empty(hmax, dtype=torch.float32, device=dev),
            ncs=torch.empty(nmax, dtype=torch.float32, device=dev),
            read_offsets=torch.empty(nmax + 1, dtype=torch.int64,
                                     device=dev)) for _ in range(2)]
        self.copied = [torch.cuda.Event(), torch.cuda.Event()]
        self.read = [torch.cuda.Event(), torch.cuda.Event()]
        self.main = torch.cuda.current_stream(dev)
        self.side = torch.cuda.Stream(dev)
        self.side.wait_stream(self.main)  # the buffers' memory is free
        self.step = 0  # partials so far; step s reads buffer s % 2
        self._load(0)

    def _load(self, j: int) -> None:
        """Copy chunk j into the buffer of partial number self.step."""
        b, c = self.step % 2, self.chunks[j]
        self.side.wait_event(self.read[b])
        with torch.cuda.stream(self.side):
            for f in _CHUNK_FIELDS:
                src = getattr(c, f)
                self.bufs[b][f][:src.shape[0]].copy_(src, non_blocking=True)
        self.copied[b].record(self.side)

    def _partials(self, state: RoundState, i: int) -> None:
        if not self.cuda:
            for c in self.chunks:
                theta_partial(state, c, i)
            return
        k = len(self.chunks)
        for j, c in enumerate(self.chunks):
            b = self.step % 2
            buf = self.bufs[b]
            h, n = c.sid.shape[0], c.ncs.shape[0]
            view = ThetaData(sid=buf["sid"][:h], rid=buf["rid"][:h],
                             cps=buf["cps"][:h], ncs=buf["ncs"][:n],
                             read_offsets=buf["read_offsets"][:n + 1],
                             M=c.M, n0=c.n0)
            self.main.wait_event(self.copied[b])
            theta_partial(state, view, i)
            self.read[b].record(self.main)
            self.step += 1
            self._load((j + 1) % k)

    def rounds(self, state: RoundState, n: int) -> None:
        """Enqueue n rounds from state.ring[0]: K1's partial on every
        chunk, then its finish (no host read)."""
        for i in range(n):
            self._partials(state, i)
            theta_finish(state, self.data, i)
        self.state = state

    def close(self) -> None:
        """Order the current stream after the last copy, so the buffers'
        memory is not reused under it."""
        if self.cuda:
            self.main.wait_stream(self.side)


def run_theta_loop_streamed(
        theta0, chunks: Sequence[ThetaData], M: int, n0: float,
        min_round: int = MIN_ROUND, max_round: int = MAX_ROUND,
        start_round: int = 0, device: DeviceLike = None,
        progress: Optional[Callable[[int, int], None]] = None
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Bounded-memory theta loop (counterpart of rsem_tpu/ops/fast_estep.py
    run_fast_em_loop_streamed; RSEM's bounded-RAM re-streaming of reads,
    ReadReader.h:21-116): `chunks` are host ThetaData of consecutive reads
    (parallel.fast_sharded.build_theta_chunks; pinned for a CUDA device),
    fed through a ChunkStream, so device memory holds at most two chunks
    and the RoundState whatever the dataset's size. The stop rule is
    run_theta_loop's, with a host read after every round
    (STREAM_SEGMENT); progress(round, stop count) is called after each.
    Returns (theta f32 [M+1], counts f64 [M+1] of the last round with
    counts[0] including n0, rounds), on the device (CUDA unless
    device="cpu")."""
    dev = resolve_device(device)
    theta = torch.as_tensor(theta0 if isinstance(theta0, torch.Tensor)
                            else np.asarray(theta0)).to(dev, torch.float32)
    if theta.shape != (M + 1,):
        raise ValueError(f"theta0 must have M+1 = {M + 1} entries")
    feed = ChunkStream(chunks, M, n0, dev)
    try:
        theta, rounds = run_theta_loop(
            theta, feed.data, min_round, max_round, start_round,
            rounds_fn=lambda st, _d, n: feed.rounds(st, n),
            segment=STREAM_SEGMENT, progress=progress)
    finally:
        feed.close()
    counts = feed.state.counts.clone() if feed.state is not None else \
        torch.zeros(M + 1, dtype=torch.float64, device=dev)
    return theta, counts, rounds


def final_fracs(theta: torch.Tensor, data: ThetaData
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final posterior responsibilities (EM.cpp:460-478): per hit
    theta[sid]*cps/denom and per read theta_0*ncs/denom, f32, in the
    original hit/read order."""
    w, w0, inv = _weights(theta, data)
    return w * inv[data.rid], w0 * inv
