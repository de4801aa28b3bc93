"""The port imports neither jax nor anything of jpeg_tpu, and builds
nothing at import time."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "jpeg_tpu_torch"


def _run(code: str, env=None) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("module", ["jpeg_tpu_torch",
                                    "jpeg_tpu_torch.pipelines.fast",
                                    "jpeg_tpu_torch.pipelines.bucket",
                                    "jpeg_tpu_torch.pipelines.progressive",
                                    "jpeg_tpu_torch.pipelines.encode",
                                    "jpeg_tpu_torch.pipelines.decode",
                                    "jpeg_tpu_torch.pipelines.speculative",
                                    "jpeg_tpu_torch.kernels.huffdec",
                                    "jpeg_tpu_torch.golden.decoder",
                                    "jpeg_tpu_torch.utils.guards",
                                    "jpeg_tpu_torch.convert",
                                    "chip_smoke"])
def test_import_leaves_jax_and_jpeg_tpu_out(module):
    out = _run(f"import sys, {module}; print(*(any(m == p or "
               f"m.startswith(p + '.') for m in sys.modules) "
               f"for p in ('jax', 'jpeg_tpu')))")
    assert out.split() == ["False", "False"]


def _imports_of(line: str) -> list[str]:
    """Top-level module names a line imports (``import a.b, c`` or
    ``from a.b import c``; relative imports name nothing)."""
    words = line.split()
    if words[:1] == ["import"]:
        return [part.split()[0].split(".")[0]
                for part in line[len("import"):].split(",") if part.strip()]
    if words[:1] == ["from"] and len(words) > 1:
        return [words[1].split(".")[0]] if words[1][0] != "." else []
    return []


@pytest.mark.parametrize("line,names", [
    ("import jpeg_tpu", ["jpeg_tpu"]),
    ("from jpeg_tpu.native import x", ["jpeg_tpu"]),
    ("from jpeg_tpu import native", ["jpeg_tpu"]),
    ("import jax.numpy as jnp, os", ["jax", "os"]),
    ("from jpeg_tpu_torch import native", ["jpeg_tpu_torch"]),
    ("from .core import tables", []),
])
def test_import_scan_reads_import_lines(line, names):
    assert _imports_of(line) == names


def test_no_file_of_the_port_imports_jax_or_jpeg_tpu():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 20
    for f in files:
        for line in f.read_text().splitlines():
            bad = {"jax", "jpeg_tpu"} & set(_imports_of(line.strip()))
            assert not bad, f"{f}: {line.strip()}"


def test_kernel_modules_import_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path))
    out = _run("import shutil, jpeg_tpu_torch.kernels.front, "
               "jpeg_tpu_torch.kernels.fused, "
               "jpeg_tpu_torch.kernels.huffdec\n"
               "from jpeg_tpu_torch import _build\n"
               "print(shutil.which('nvcc'), _build._libs)", env=env)
    assert out.split() == ["None", "{}"]


def test_cuda_request_without_nvcc_raises(monkeypatch):
    from jpeg_tpu_torch import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "CUDA_NVCC", "/nonexistent/bin/nvcc")
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.entry("front_dct")


def test_every_kernel_has_a_source_and_an_entry_point():
    from jpeg_tpu_torch import _build
    from jpeg_tpu_torch.kernels import KERNELS
    assert set(_build.SIGNATURES) == set(KERNELS)
    assert set(_build.SOURCES) == {p.stem for p in (PKG / "csrc").glob("*.cu")}
    for name, (source, fn, _) in _build.SIGNATURES.items():
        src = (PKG / "csrc" / f"{source}.cu").read_text()
        assert f'extern "C" int {fn}(' in src
        assert "return (int)cudaGetLastError();" in src
        assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)


def test_kernel_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh must rebuild every kernel that includes it."""
    from jpeg_tpu_torch import _build
    assert [p.split("/")[-1] for p in _build.sources("symbolize_fields")] \
        == ["symbolize_fields.cu", "block_slots.cuh"]
    for name in _build.SOURCES:
        (tmp_path / f"{name}.cu").write_bytes(
            (PKG / "csrc" / f"{name}.cu").read_bytes())
    header = (PKG / "csrc" / "block_slots.cuh").read_bytes()
    (tmp_path / "block_slots.cuh").write_bytes(header)
    monkeypatch.setattr(_build, "SRC_DIR", str(tmp_path))
    before = {n: _build._target(n)[1] for n in _build.SOURCES}
    (tmp_path / "block_slots.cuh").write_bytes(header + b"// edited\n")
    after = {n: _build._target(n)[1] for n in _build.SOURCES}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == {"symbolize_bits", "symbolize_fields", "attach_pf"}
