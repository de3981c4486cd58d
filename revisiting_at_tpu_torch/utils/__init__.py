from .flops import forward_flops, param_count, sizeof_fmt
from .logging import EvalLogger, RunLogger, make_run_name

__all__ = ["EvalLogger", "RunLogger", "forward_flops", "make_run_name", "param_count",
           "sizeof_fmt"]
