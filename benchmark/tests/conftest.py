"""Fixtures of the benchmark's own tests (run them with
``python -m pytest benchmark/tests``; the card's test is marked ``cuda``
and skips without one)."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cell at a size the CPU's plain twins run in seconds
TINY_CONFIGS = {"cam640-dyn": (64, 64), "photo1920-fixed": (64, 96),
                "photo1920-fixed-dp4": (64, 96)}
TINY_TRAFFIC = {"stream-b64-d4": {"batch": 4},
                "stream-b16-d4": {"batch": 3},
                "stream-b16-d4-dev": {"batch": 3},
                "decode-b8-pool32": {"batch": 4, "pool": 8, "sources": 2,
                                     "check_images": 4},
                "sharded-b16": {"batch": 8, "rank_timeout_s": 120}}
SEED = 2 ** 31 + 977
# one coefficient of a 64x64 file is 1/6144 of it, so a rounding flip of
# float32 against float64 there reads 1.6e-4; the tiny cells hold the
# share to 1e-3 (the bfloat16 control reads about 3e-3 at any size)
TINY_COEF_SHARE = 1e-3


def _tiny_limits(c: dict) -> None:
    for group in c["limits"].values():
        if "worst_coef_diff_share" in group:
            group["worst_coef_diff_share"] = TINY_COEF_SHARE


def _edit(path: str, update) -> None:
    with open(path) as f:
        obj = json.load(f)
    update(obj)
    with open(path, "w") as f:
        json.dump(obj, f)


def make_root(tmp_path) -> str:
    """A checkout of the benchmark in ``tmp_path`` with every cell cut to
    a tiny size (the program linked in), and the parked cells
    (``parked_cells.json``: measured, not yet boundable) added to its
    ``BENCHMARK.json`` so that their code is rehearsed too."""
    root = str(tmp_path / "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        spec = json.load(f)
    with open(os.path.join(BENCH, "tests", "parked_cells.json")) as f:
        parked = json.load(f)
    also = parked.pop("also_report")  # metric -> the parked cells it reads
    for key, entries in parked.items():
        spec[key] += entries
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.get("workloads", []).extend(also.get(m["name"], []))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    os.symlink(os.path.join(ROOT, "jpeg_tpu_torch"),
               os.path.join(root, "jpeg_tpu_torch"))
    for name, (h, w) in TINY_CONFIGS.items():
        _edit(os.path.join(root, "benchmark", "configs", name + ".json"),
              lambda c: (c.update(height=h, width=w), _tiny_limits(c)))
    for name, upd in TINY_TRAFFIC.items():
        _edit(os.path.join(root, "benchmark", "traffic", name + ".json"),
              lambda t: t.update(upd))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> str:
    return make_root(tmp_path)


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided here, at run time)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.cuda.get_device_name(0)
