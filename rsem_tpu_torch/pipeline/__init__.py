from .calculate_expression import ExpressionConfig, calculate_expression
from .prepare_reference import main as prepare_reference_main

__all__ = [
    "ExpressionConfig",
    "calculate_expression",
    "prepare_reference_main",
]
