"""The port never imports jax, and builds nothing at import time."""
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
                                    "jpeg_tpu_torch.convert",
                                    "chip_smoke"])
def test_import_leaves_jax_out(module):
    out = _run(f"import sys, {module}; print('jax' in sys.modules, "
               f"any(m.startswith('jax.') for m in sys.modules))")
    assert out.split() == ["False", "False"]


def test_no_file_of_the_port_imports_jax():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 10
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split()
            assert words[:2] not in (["import", "jax"], ["from", "jax"]), f
            assert not (words[:1] == ["from"] and words[1:2]
                        and words[1].startswith("jax.")), f


def test_kernel_modules_import_without_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path))
    out = _run("import shutil, jpeg_tpu_torch.kernels.front, "
               "jpeg_tpu_torch.kernels.fused\n"
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
    for name, (fn, _) in _build.SIGNATURES.items():
        src = (PKG / "csrc" / f"{name}.cu").read_text()
        assert f'extern "C" int {fn}(' in src
        assert "return (int)cudaGetLastError();" in src
        assert "--use_fast_math" not in " ".join(_build.NVCC_FLAGS)
