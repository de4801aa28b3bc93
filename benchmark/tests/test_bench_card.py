"""On the card only: one short run of each one-card cell through the
command, its result line as the contract reads it (skips without a
CUDA device)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


@pytest.mark.cuda
@pytest.mark.parametrize("workload,trace", [
    ("enc1920-fixed-stream-dev", 0), ("enc1920-fixed-stream-dev", 1),
    ("dec1920-batch", 1)])
def test_a_short_run_on_the_card(card, workload, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(2 ** 31 + 5), "--seconds", "2", "--trace",
         str(trace)], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["kind"] == card
    assert list(line)[-1] == "compared"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert all(0 <= m["value"] <= 100 for k, m in line["metrics"].items()
                   if m["unit"] == "%")
    else:
        assert "setup_s" in line["metrics"]
