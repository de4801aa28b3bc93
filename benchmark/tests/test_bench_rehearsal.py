"""Each kind of cell end to end on the CPU's plain twins at a tiny size,
with the check for a card skipped: it runs, judges what it produced as
correct, and prints no device metric.  The same runs with the timed path
broken underneath, and the control, must come out not correct."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import pytest

from benchmark import control, harness
from conftest import SEED

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SPEC_CELLS = [w["name"] for w in harness.load_spec(ROOT)["workloads"]]
# and the parked ones, which conftest.make_root adds
CELLS = SPEC_CELLS + ["enc640-dyn-stream", "enc1920-fixed-stream",
                      "enc1920-fixed-dp4"]


def rehearse(root: str, workload: str, **kw) -> harness.Outcome:
    cell = harness.load_cell(harness.load_spec(root), workload, root)
    if cell.traffic["kind"] == "sharded_encode":
        kw.setdefault("root", root)
    return harness.driver(cell.traffic["kind"]).run(
        cell, SEED, 6.0, False, time.time(), device="cpu", **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_cell_runs_and_is_correct(tiny_root, workload):
    out = rehearse(tiny_root, workload)
    cell = harness.load_cell(harness.load_spec(tiny_root), workload,
                             tiny_root)
    line = harness.result(cell, out, False)
    assert out.correct, out.numbers
    assert out.attempted > 0 and out.failed == 0
    assert line["metrics"] == {}  # no number off the card is a device's
    assert line["device"]["platform"] == "cpu"
    assert set(line["compared"]) == set(out.limits)


@pytest.mark.parametrize("workload", SPEC_CELLS)
def test_the_command_refuses_to_run_without_a_card(workload):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", workload,
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(tiny_root, workload, capsys):
    rc = control.main(["--workload", workload, "--seeds", "11", "12"],
                      root=tiny_root, device="cpu")
    assert rc == 0, capsys.readouterr().err


# -- faults planted under the timed path ------------------------------------

def flip_a_byte(data: bytes) -> bytes:
    """One byte of the scan, near its end, altered."""
    f = bytearray(data)
    f[len(f) - 8] ^= 0x5A
    return bytes(f)


# The check judges a seeded sample of the answers, so each fault alters
# every answer it touches: one wrong file in a batch of 16 escapes a
# sample of 6 with probability (15/16)^6.

def _altered_files(monkeypatch):
    """Every file has one byte of its scan flipped where it is made."""
    from jpeg_tpu_torch.pipelines.fast import FastBatchEncoder
    assemble = FastBatchEncoder._assemble

    def broken(self, *a, **k):
        return [flip_a_byte(f) for f in assemble(self, *a, **k)]
    monkeypatch.setattr(FastBatchEncoder, "_assemble", broken)


def _half_the_batch(monkeypatch):
    """The second half of a batch's files are the first half's again."""
    from jpeg_tpu_torch.pipelines.fast import FastBatchEncoder
    assemble = FastBatchEncoder._assemble

    def broken(self, *a, **k):
        files = assemble(self, *a, **k)
        half = len(files) // 2
        return files[:half] + files[:len(files) - half]
    monkeypatch.setattr(FastBatchEncoder, "_assemble", broken)


def _decode_broken(how):
    def plant(monkeypatch):
        import jpeg_tpu_torch
        import torch
        decode = jpeg_tpu_torch.decode_jpeg_batch

        def broken(datas, **k):
            imgs = decode(datas, **k)
            if how in ("altered", "off_by_one"):
                by = 3 if how == "altered" else 1
                return [(im.to(torch.int16) + by).clamp_(0, 255)
                        .to(torch.uint8) for im in imgs]
            half = len(imgs) // 2
            return imgs[:half] + imgs[:len(imgs) - half]
        monkeypatch.setattr(jpeg_tpu_torch, "decode_jpeg_batch", broken)
    return plant


@pytest.mark.parametrize("workload,plant", [
    ("enc640-dyn-stream", _altered_files),
    ("enc640-dyn-stream", _half_the_batch),
    ("enc1920-fixed-stream", _altered_files),
    ("enc1920-fixed-stream", _half_the_batch),
    ("enc1920-fixed-stream-dev", _altered_files),
    ("enc1920-fixed-stream-dev", _half_the_batch),
    ("dec1920-batch", _decode_broken("altered")),
    ("dec1920-batch", _decode_broken("off_by_one")),
    ("dec1920-batch", _decode_broken("half")),
])
def test_a_broken_timed_path_is_not_correct(tiny_root, workload, plant,
                                            monkeypatch):
    plant(monkeypatch)
    assert not rehearse(tiny_root, workload).correct


@pytest.mark.parametrize("fault", ["no_exchange", "altered"])
def test_a_broken_sharded_path_is_not_correct(tiny_root, fault):
    worker = [sys.executable, os.path.join(BENCH, "tests", "fault_rank.py"),
              fault]
    assert not rehearse(tiny_root, "enc1920-fixed-dp4", worker=worker).correct
