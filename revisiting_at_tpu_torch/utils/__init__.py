from .logging import EvalLogger

__all__ = ["EvalLogger"]
