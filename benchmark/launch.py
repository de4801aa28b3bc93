"""One local process a rank, all waited on with one deadline.

A frozen copy of ``jpeg_tpu_torch/parallel/launch.py::run_ranks`` as it
stood when the benchmark was written, so that a change to the program's
launcher leaves the yardstick as it is.  A rank that exits with an
error, or a group that has not ended by the deadline (a hung rendezvous
included), has every rank still running killed, and ``RuntimeError``
carries the end of each rank's stderr.
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
        tails = []
        for r, p in enumerate(procs):
            with open(logs[r], errors="replace") as f:
                tails.append(f"rank {r} exited {p.returncode}:\n"
                             + f.read()[-3000:])
        raise RuntimeError(
            f"{len(commands)} ranks: "
            + (f"killed after {timeout_s} s" if late else "a rank failed")
            + "\n" + "\n".join(tails))
