"""Start `world` local ranks of a command, as torchrun does on one host: each
process gets RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT (a
free port of localhost), and the launcher waits for all of them within a
time limit. A rank that fails, or a run that outlives the limit, fails the
run at once, and no process is left behind: the others are killed."""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time


def free_port() -> int:
    """A TCP port of localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: list[str], world: int, timeout_s: float, env: dict | None = None,
              cwd: str | None = None, local_ranks: list[int] | None = None) -> list[str]:
    """Run `argv` in `world` processes; returns each rank's output (stdout
    and stderr). local_ranks: each rank's LOCAL_RANK (its device), rank r's
    own by default. Raises RuntimeError with the output's end of the ranks
    that failed, or when the run outlives timeout_s."""
    port = str(free_port())
    deadline = time.monotonic() + timeout_s
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
        procs: list[subprocess.Popen] = []
        try:
            for r in range(world):
                e = dict(os.environ if env is None else env, RANK=str(r), WORLD_SIZE=str(world),
                         LOCAL_RANK=str(r if local_ranks is None else local_ranks[r]),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
                procs.append(subprocess.Popen(argv, stdout=logs[r], stderr=subprocess.STDOUT,
                                              text=True, env=e, cwd=cwd))
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break  # a rank failed: the others may wait on it forever
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    codes = [p.returncode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"{argv}: exit codes {codes} (killed: the run failed or ran past "
                           f"{timeout_s} s)\n" + "\n".join(
                               f"--- rank {r} (exit {c}):\n{outs[r][-4000:]}"
                               for r, c in enumerate(codes) if c != 0))
    return outs
