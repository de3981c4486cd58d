from .logging import EvalLogger, RunLogger, make_run_name

__all__ = ["EvalLogger", "RunLogger", "make_run_name"]
