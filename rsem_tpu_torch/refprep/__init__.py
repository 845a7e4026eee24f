from .transcripts import Transcript, Transcripts, GroupInfo
from .reference import Reference, PolyARules
from .gtf import parse_gtf
from .extract import extract_reference_transcripts
from .synthesis import synthesize_reference_transcripts
from .prepare import prepare_reference

__all__ = [
    "Transcript",
    "Transcripts",
    "GroupInfo",
    "Reference",
    "PolyARules",
    "parse_gtf",
    "extract_reference_transcripts",
    "synthesize_reference_transcripts",
    "prepare_reference",
]
