"""Static model configuration shared by host estimation and device kernels.

Mirrors the reference's ModelParams (ModelParams.h) plus the read_type switch
(EM.cpp:661-666): model types 0 single / 1 single+qual / 2 paired /
3 paired+qual collapse to two static flags.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import (
    DEFAULT_MAXL,
    DEFAULT_MINL,
    DEFAULT_SEED_LEN,
    EPSILON,
    RSPD_DEFAULT_B,
)


@dataclass(frozen=True)
class ModelSpec:
    model_type: int  # 0..3
    est_rspd: bool = False
    B: int = RSPD_DEFAULT_B
    minL: int = DEFAULT_MINL
    maxL: int = DEFAULT_MAXL
    mate_minL: int = DEFAULT_MINL
    mate_maxL: int = DEFAULT_MAXL
    mean: float = -1.0
    sd: float = 0.0
    probF: float = 0.5
    seed_len: int = DEFAULT_SEED_LEN
    has_polya: bool = False

    @property
    def paired(self) -> bool:
        return self.model_type >= 2

    @property
    def has_qual(self) -> bool:
        return self.model_type in (1, 3)

    @property
    def use_mld_single(self) -> bool:
        """Single-end with a user-specified fragment dist: gld is the Normal
        fragment dist and mld holds observed read lengths
        (SingleModel.h:67-70)."""
        return (not self.paired) and self.mean >= EPSILON

    @property
    def has_mld(self) -> bool:
        return self.paired or self.use_mld_single

    def write_mparams(self, path: str):
        """Interop .mparams (rsem-calculate-expression:606-615)."""
        with open(path, "w") as f:
            f.write(f"{self.minL} {self.maxL}\n")
            f.write(f"{self.probF}\n")
            f.write(f"{int(self.est_rspd)}\n")
            f.write(f"{self.B}\n")
            f.write(f"{self.mate_minL} {self.mate_maxL}\n")
            f.write(f"{self.mean} {self.sd}\n")
            f.write(f"{self.seed_len}\n")

    @classmethod
    def read_mparams(cls, path: str, model_type: int, has_polya: bool) -> "ModelSpec":
        with open(path) as f:
            tok = iter(f.read().split())
        minL, maxL = int(next(tok)), int(next(tok))
        probF = float(next(tok))
        est_rspd = int(next(tok)) != 0
        B = int(next(tok))
        mate_minL, mate_maxL = int(next(tok)), int(next(tok))
        mean, sd = float(next(tok)), float(next(tok))
        seed_len = int(next(tok))
        return cls(
            model_type=model_type,
            est_rspd=est_rspd,
            B=B,
            minL=minL,
            maxL=maxL,
            mate_minL=mate_minL,
            mate_maxL=mate_maxL,
            mean=mean,
            sd=sd,
            probF=probF,
            seed_len=seed_len,
            has_polya=has_polya,
        )
