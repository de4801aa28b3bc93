"""BENCHMARK.json against its contract, and the harness finding every
file of a cell by name."""
from __future__ import annotations

import json
import os
import re
import shutil
import time

import pytest

from benchmark import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec(ROOT)


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_text():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in SPEC[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in SPEC["workloads"]]
                 + [c["source"] for c in SPEC["configs"]]
                 + [m["layer"] for m in SPEC["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_the_contract_asks():
    four = [w for w in SPEC["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        cell = harness.load_cell(SPEC, w["name"], ROOT)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer, w["name"]
        assert cell.chips == w["chips"] == cell.config["chips"]


def test_cells_resolve_to_their_files_by_name():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(SPEC, w["name"], ROOT)
        conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
        assert conf["file"] == f"benchmark/configs/{w['config']}.json"
        assert cell.config["name"] == w["config"]
        assert cell.config["reduced"] == conf["reduced"]
        assert os.path.exists(os.path.join(
            BENCH, "traffic", w["traffic"] + ".json"))
        assert harness.driver(cell.traffic["kind"]).run
    for m in SPEC["per_layer"]:
        mod = harness.load_metric(BENCH, m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_check_budget_fits():
    """A full check of 24 cells at run_seconds fits its 43200 s budget:
    2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s of compile a
    cell, 1200 s spare."""
    cells = 24
    total = ((2 + 14 * cells) * (SPEC["run_seconds"] + 60)
             + cells * 2 * 90 + 1200)
    assert total <= 43200


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    """Adding a configuration, a traffic mix of an existing kind and a
    per-layer metric takes new files and new entries in BENCHMARK.json;
    no file of the benchmark changes."""
    root = str(tmp_path / "root")
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in _files(root)}
    with open(os.path.join(BENCH, "configs", "cam640-dyn.json")) as f:
        conf = json.load(f)
    conf.update(name="cam320-dyn", height=64, width=48)
    conf["limits"]["encode"]["worst_coef_diff_share"] = 1e-3  # a tiny file
    _write(root, "benchmark/configs/cam320-dyn.json", conf)
    _write(root, "benchmark/traffic/stream-b8-d2.json",
           {"kind": "stream_encode", "rate_metric": "encode_mp_s",
            "batch": 2, "sync_depth": 2, "pool_batches": 2,
            "check_files": 2, "trace_batches": 4})
    with open(os.path.join(root, "benchmark/metrics/batches.encode.py"),
              "w") as f:
        f.write('UNIT, LAYER, MOVES = "batches", "stream entry", '
                '"encode_mp_s"\n\n\ndef read(record, cell):\n'
                '    return record.get("steps") or None\n')
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "cam320-dyn", "source": "x",
                            "file": "benchmark/configs/cam320-dyn.json",
                            "reduced": [], "why": "x"})
    spec["workloads"].append({"name": "enc320-dyn-stream",
                              "config": "cam320-dyn",
                              "traffic": "stream-b8-d2", "chips": 1,
                              "why": "x"})
    for m in spec["end_to_end"]:
        if m["name"] == "encode_mp_s":
            m["workloads"].append("enc320-dyn-stream")
    spec["per_layer"].append({"name": "batches.encode", "unit": "batches",
                              "better": "higher", "source": "host_clock",
                              "layer": "stream entry",
                              "moves": "encode_mp_s",
                              "workloads": ["enc320-dyn-stream"]})
    _write(root, "BENCHMARK.json", spec)
    cell = harness.load_cell(harness.load_spec(root), "enc320-dyn-stream",
                             root)
    assert (cell.config["height"], cell.traffic["batch"]) == (64, 2)
    assert [m["name"] for m, _ in cell.per_layer] == ["batches.encode"]
    assert cell.per_layer[0][1].read({"steps": 7}, cell) == 7
    assert {m["name"] for m in cell.end_to_end} == {"encode_mp_s",
                                                    "setup_s"}
    # and the new cell runs, here on the CPU's plain twins
    out = harness.driver("stream_encode").run(cell, 5, 0.5, False,
                                              time.time(), device="cpu")
    assert out.correct and out.attempted > 0
    for path, data in before.items():
        assert open(path, "rb").read() == data


def _files(root):
    for d, _, names in os.walk(os.path.join(root, "benchmark")):
        for n in names:
            yield os.path.join(d, n)


def _write(root, rel, obj):
    with open(os.path.join(root, rel), "w") as f:
        json.dump(obj, f)


@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_unknown_workload_is_refused(name):
    with pytest.raises(KeyError):
        harness.load_cell(SPEC, name + "-x", ROOT)
