from .em import EMConfig, EMResult, run_em

__all__ = ["EMConfig", "EMResult", "run_em"]
