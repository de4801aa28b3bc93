"""What every cell shares: finding its files by name, the checks that
bar a run, the spans and samples of the window, and the result line.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix.  ``configs/<config>.json`` holds the
deployment, ``traffic/<traffic>.json`` the entry point (``kind``, which is
the module under ``drivers/`` that runs it) and its parameters, and
``metrics/<metric>.py`` each per-layer reader.  Adding a configuration, a
mix of an existing kind or a metric adds files and entries; no file
here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded where the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "jpeg_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list     # BENCHMARK.json entries this cell reports
    per_layer: list      # (entry, reader module)


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(bench_dir: str, name: str):
    """``metrics/<name>.py`` as a module (names hold dots, so it is loaded
    by path)."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def load_cell(spec: dict, workload: str, root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``spec`` with its files, found by name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    bench_dir = os.path.join(root, spec["paths"][0])
    config = _json(os.path.join(root, conf["file"]))
    traffic = _json(os.path.join(bench_dir, "traffic", w["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [(m, load_metric(bench_dir, m["name"]))
                 for m in spec["per_layer"]
                 if m["moves"] in names and _reports(m, workload)]
    return Cell(workload, config, traffic, w["chips"], e2e, per_layer)


def driver(kind: str):
    """The module that runs a traffic mix of this kind."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``jpeg_tpu_torch`` is not ``jpeg_tpu``)."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def cards(chips: int) -> None:
    """Raise ``SystemExit`` unless ``chips`` CUDA devices are there (a run
    never falls back to the CPU).  Opens no context on a card: a rank
    process takes each card of a cell on several."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark runs on the card "
                         "only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} present")


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``rng``
    (seeded, so one seed keeps the same items of the same stream)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.seen = k, rng, 0
        self.items: list = []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def p95(values) -> float | None:
    """The 95th percentile (nearest rank) of at least 20 values."""
    if len(values) < 20:
        return None
    v = sorted(values)
    return v[math.ceil(0.95 * len(v)) - 1]


@dataclasses.dataclass
class Outcome:
    """What a driver's run measured and judged."""
    attempted: int
    failed: int
    rates: dict           # end-to-end metric name -> value
    setup_s: float
    numbers: dict         # compared number -> value
    limits: dict          # compared number -> limit
    correct: bool         # judged so, and something done in the window
    device: dict          # platform, kind, count, memory_peak_bytes
    record: dict | None = None  # spans, counters, trace: for --trace 1
    notes: list = dataclasses.field(default_factory=list)


def result(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The result line: the cell's end-to-end metrics (``--trace 0``) or
    its per-layer metrics (``--trace 1``), then the numbers compared."""
    metrics = {}
    if out.device["platform"] != "gpu":
        pass  # a rehearsal off the card measures nothing
    elif not trace:
        for m in cell.end_to_end:
            value = out.setup_s if m["name"] == "setup_s" \
                else out.rates.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        record = dict(out.record or {}, device=out.device["kind"])
        for m, reader in cell.per_layer:
            value = reader.read(record, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": dict(out.device)}
    if trace and out.record and out.record.get("trace"):
        from .devtrace import breakdown
        tr = out.record["trace"]
        line["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["breakdown"] = breakdown(tr)
    line["compared"] = {k: {"value": v, "limit": out.limits[k]}
                        for k, v in out.numbers.items()}
    return line


def setup_note(start: float, marks: list[float]) -> str:
    """Where set-up went: process start to the cell's run (imports, CUDA),
    the input pool, the program's set-up and warm-up (kernels load or
    build here)."""
    parts = zip(("start", "pool", "program and warm-up"),
                [marks[0] - start] + [b - a for a, b in zip(marks, marks[1:])])
    return "setup: " + ", ".join(f"{k} {v:.3f} s" for k, v in parts)


def bits_note(items, pixels: int) -> str:
    """Bits a pixel of the sampled files ((batch, image, file) items)."""
    if not items:
        return "bits per pixel: no file sampled"
    bpp = 8 * sum(len(d) for *_, d in items) / (len(items) * pixels)
    return f"bits per pixel of the {len(items)} files checked: {bpp:.4f}"


def device_info(device: str, count: int, memory_peak: int,
                kind: str | None = None) -> dict:
    """The result line's ``device``: the card's name as CUDA gives it
    (``kind``, else asked here; a CPU rehearsal says "cpu" and prints no
    device metric)."""
    if device != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": memory_peak}
    if kind is None:
        import torch
        kind = torch.cuda.get_device_name(0)
    return {"platform": "gpu", "kind": kind, "count": count,
            "memory_peak_bytes": memory_peak}
