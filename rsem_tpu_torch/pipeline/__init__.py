from .calculate_expression import ExpressionConfig, calculate_expression

__all__ = ["ExpressionConfig", "calculate_expression"]
