from .transcripts import Transcript, Transcripts, GroupInfo
from .reference import Reference, PolyARules

__all__ = [
    "Transcript",
    "Transcripts",
    "GroupInfo",
    "Reference",
    "PolyARules",
]
