"""The work a sample defines, counted from its own sizes.

Each function counts the bytes and operations that the algorithm needs, not
what the port's kernels happen to move: a later change that shrinks or fuses
the port's intermediates (PreIdx, the per-round tables) then reads as a
larger share of the same least time, and the yardstick does not go stale.
Every byte read is counted once and every byte written once.

`Work` holds the sizes of one sample as it ran: hits H, aligned read pairs
N, isoforms M, read length L (both mates), and the EM's model-update rounds
and theta rounds.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

# bytes per item
BASE = 1  # a read or reference base code
QUAL = 1  # a quality score
F32 = 4  # a conprb, a theta entry, a count
I32 = 4  # a transcript id, an assignment
HIT = 4 + 4 + 4 + 1  # a hit's transcript, position, fragment length, strand
TABLE_SLOTS = 100 * 5 * 5 + 100 * 5  # quality and noise profiles


class Work(NamedTuple):
    hits: int
    reads: int  # aligned pairs
    isoforms: int
    read_len: int  # per mate
    model_rounds: int
    theta_rounds: int


def model_loop(w: Work) -> Tuple[float, float]:
    """(bytes, operations) of the model-update rounds: per round and hit,
    its record and the read's bases and qualities of both mates and the
    reference span they are compared with; per round and read, its bases
    and qualities for the noise profile; the model's tables read and
    written once a round. Operations: per compared base, a table lookup
    summed into the hit's log-likelihood and a weight added into the
    table's statistics (2 each); per hit, its weight added into the read's
    denominator, its transcript's count, and the fragment-length and two
    read-start statistics."""
    bases = 2 * w.read_len
    per_hit = HIT + bases * (BASE + QUAL) + bases * BASE
    per_read = bases * (BASE + QUAL)
    tables = 2 * TABLE_SLOTS * F32
    per_round = w.hits * per_hit + w.reads * per_read + tables
    ops = (w.hits + w.reads) * bases * 4 + w.hits * 5
    return float(w.model_rounds * per_round), float(w.model_rounds * ops)


def theta_loop(w: Work) -> Tuple[float, float]:
    """(bytes, operations) of the theta-only rounds and the final count
    (kernel K1): per round and hit its conprb and transcript id; per round
    and read its noise conprb; theta read and written once. Operations:
    per hit a product, a sum into the read's denominator, a quotient and a
    sum into its transcript's count."""
    rounds = w.theta_rounds + 1  # the final expected counts are one more
    per_round = (w.hits * (F32 + I32) + w.reads * F32
                 + 2 * (w.isoforms + 1) * F32)
    ops = w.hits * 4 + w.reads * 2 + 2 * (w.isoforms + 1)
    return float(rounds * per_round), float(rounds * ops)
