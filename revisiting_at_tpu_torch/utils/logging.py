"""Run directories, JSON-lines metric logging and evaluation logs, port of
revisiting_at_tpu/utils/logging.py: the run dir is named from arch, flags
and a timestamp, and the `log` file holds one JSON object per line with
absolute and relative timestamps."""

from __future__ import annotations

import json
import time
from pathlib import Path


class RunLogger:
    """Appends JSON records to <folder>/<run_name>/log and prints them."""

    def __init__(self, folder: str, run_name: str):
        self.dir = Path(folder) / run_name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.log_path = self.dir / "log"
        self.start_time = time.time()

    def log(self, content: dict) -> None:
        cur_time = time.time()
        entry = {"timestamp": cur_time, "relative_time": cur_time - self.start_time, **content}
        line = json.dumps(entry, default=str)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")
        print(line, flush=True)


def make_run_name(arch: str, attack: str, not_original: int, updated: int,
                  addendum: str = "") -> str:
    """Reference-style run folder name."""
    stamp = time.strftime("%Y-%m-%d_%H:%M:%S")
    parts = [f"model_{stamp}", arch, f"upd_{updated}", f"not_orig_{not_original}",
             f"adv_{attack}"]
    if addendum:
        parts.append(addendum)
    return "_".join(parts)


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
