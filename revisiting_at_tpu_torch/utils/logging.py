"""Evaluation logging, port of EvalLogger in revisiting_at_tpu/utils/logging.py."""

from __future__ import annotations

from pathlib import Path


class EvalLogger:
    """Append-only text logger: prints each message and appends it to log_path."""

    def __init__(self, log_path: str | None):
        self.log_path = log_path
        if log_path:
            Path(log_path).parent.mkdir(parents=True, exist_ok=True)

    def log(self, msg: str) -> None:
        print(msg, flush=True)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(str(msg) + "\n")
