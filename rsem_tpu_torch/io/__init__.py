from .reads import ReadArrays, PairedReadArrays, ReadStats, calc_low_quality
from .hits import HitArrays, CntStats
from .sam import parse_alignments, AlignmentBundle

__all__ = [
    "ReadArrays",
    "PairedReadArrays",
    "ReadStats",
    "calc_low_quality",
    "HitArrays",
    "CntStats",
    "parse_alignments",
    "AlignmentBundle",
]
