"""One local process a rank, all waited on with one deadline.

``run_ranks`` starts the command of each rank with its stderr in a file,
and waits for all of them.  A rank that exits with an error, or a group
that has not ended when the deadline passes (a hung rendezvous
included), has every rank still running killed and raises
``RuntimeError`` with the end of each rank's stderr.  What a rank returns it writes to a file of
its own, which the caller reads.  The port's multi-process CPU tests
and ``chip_smoke.py``'s split over several cards start their ranks
through it.
"""
from __future__ import annotations

import os
import subprocess
import time


def run_ranks(commands: list[list[str]], log_dir: str, timeout_s: float,
              env: dict | None = None, cwd: str | None = None) -> None:
    """Run ``commands[r]`` as rank ``r``, its stderr to
    ``log_dir/rank{r}.err``, until every rank has exited 0; as soon as
    one fails, or when ``timeout_s`` has passed, kill the others and
    raise."""
    logs = [os.path.join(log_dir, f"rank{r}.err")
            for r in range(len(commands))]
    procs = []
    late = False
    try:
        for cmd, log in zip(commands, logs):
            with open(log, "wb") as err:
                procs.append(subprocess.Popen(
                    cmd, env=env, cwd=cwd, stdout=subprocess.DEVNULL,
                    stderr=err))
        deadline = time.monotonic() + timeout_s
        # until all have exited, one has failed or the deadline passed
        while True:
            codes = [p.poll() for p in procs]
            if None not in codes or any(codes):
                break
            if time.monotonic() > deadline:
                late = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if late or any(p.returncode for p in procs):
        tails = "\n".join(
            f"rank {r} exited {p.returncode}:\n"
            + open(logs[r], errors="replace").read()[-3000:]
            for r, p in enumerate(procs))
        raise RuntimeError(
            f"{len(commands)} ranks: "
            + (f"killed after {timeout_s} s" if late else "a rank failed")
            + "\n" + tails)
