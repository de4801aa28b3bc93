"""``python -m jpeg_tpu_torch`` (``jpeg_tpu_torch.__main__.main`` with
``--device cpu``) against ``jpeg_tpu.__main__.main``: every subcommand on
the same inputs writes the same files under the same names and prints the
same lines.  ``decode --host`` PPMs are equal; the device decode lies
within ``jpeg_tpu``'s device-vs-host bound (max |diff| <= 2, > 99.9 %
within 1, ``tests/test_device_decode.py``) of ``jpeg_tpu``'s."""
import os
import subprocess
import sys

import numpy as np
import pytest

from jpeg_tpu.__main__ import main as jax_main
from jpeg_tpu_torch.__main__ import main as port_main
from jpeg_tpu_torch.io.ppm import read_ppm, write_ppm

ENCODES = {
    "default": [],
    "q85": ["--quality", "85"],
    "fixed interleaved r2": ["--fixed", "--interleaved", "--restart", "2"],
    "422": ["--subsampling", "422"],
    "gray": ["--gray"],
    "progressive": ["--progressive"],
    "successive": ["--successive"],
}


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 255 // w, yy * 255 // h, (xx * yy) % 256], -1)
    img[h // 4:h // 2, w // 3:w // 2] = rng.integers(0, 256, 3)
    return np.clip(img + rng.integers(-6, 7, img.shape), 0, 255).astype(
        np.uint8)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_in")
    paths = {}
    for name, (h, w) in {"img": (64, 48), "odd": (50, 60)}.items():
        paths[name] = str(d / f"{name}.ppm")
        write_ppm(paths[name], _image(h, w, len(name)))
    return paths


def _run(main, argv, outdir, capsys):
    """Run ``main(argv)`` with ``{out}`` in argv naming ``outdir``: its
    return code and its printed lines with ``outdir`` written ``{out}``."""
    os.makedirs(outdir, exist_ok=True)
    argv = [a.replace("{out}", str(outdir)) for a in argv]
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out.replace(str(outdir), "{out}")


def _both(argv, tmp_path, capsys):
    """Run the port (``--device cpu``) and jpeg_tpu on ``argv``; hold their
    return codes and printed lines equal; return the two output dirs."""
    want = _run(jax_main, argv, tmp_path / "jax", capsys)
    got = _run(port_main, ["--device", "cpu", *argv], tmp_path / "port",
               capsys)
    assert got == want
    return tmp_path / "port", tmp_path / "jax"


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


@pytest.fixture(scope="module")
def jax_encodes(inputs, tmp_path_factory):
    """jpeg_tpu's encode of each ENCODES case (and of the odd-sized image
    by default): (file bytes, printed lines), once per module."""
    d = tmp_path_factory.mktemp("cli_jax")
    out = {}
    for label, opts in [*ENCODES.items(), ("odd", [])]:
        src = inputs["odd" if label == "odd" else "img"]
        dst = str(d / "x.jpg")
        rc = jax_main(["encode", src, dst, *opts])
        out[label] = (rc, open(dst, "rb").read())
    return out


@pytest.mark.parametrize("label", [*ENCODES, "odd"])
def test_encode_matches(inputs, jax_encodes, tmp_path, capsys, label):
    src = inputs["odd" if label == "odd" else "img"]
    dst = str(tmp_path / "x.jpg")
    capsys.readouterr()
    rc = port_main(["--device", "cpu", "encode", src, dst,
                    *ENCODES.get(label, [])])
    printed = capsys.readouterr().out
    assert (rc, open(dst, "rb").read()) == jax_encodes[label]
    # the same line as jpeg_tpu's, which the fixture ran on its own path
    capsys.readouterr()
    jax_main(["encode", src, dst, *ENCODES.get(label, [])])
    assert printed == capsys.readouterr().out


def _within_bound(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert got.shape == want.shape
    assert diff.max() <= 2 and np.mean(diff <= 1) > 0.999


@pytest.mark.parametrize("label", ["default", "fixed interleaved r2",
                                   "gray", "progressive"])
def test_decode_matches(inputs, jax_encodes, tmp_path, capsys, label):
    jpg = tmp_path / "in.jpg"
    jpg.write_bytes(jax_encodes[label][1])
    port, jax = _both(["decode", str(jpg), "{out}/host.ppm", "--host"],
                      tmp_path, capsys)
    _same_files(port, jax)
    port, jax = _both(["decode", str(jpg), "{out}/dev.ppm"], tmp_path,
                      capsys)
    _within_bound(read_ppm(str(port / "dev.ppm")),
                  read_ppm(str(jax / "dev.ppm")))


def test_decode_batch_matches(jax_encodes, tmp_path, capsys):
    srcs = []
    for label in ("default", "fixed interleaved r2"):
        p = tmp_path / f"{label.replace(' ', '_')}.jpg"
        p.write_bytes(jax_encodes[label][1])
        srcs.append(str(p))
    port, jax = _both(["decode-batch", *srcs, "--outdir", "{out}"],
                      tmp_path, capsys)
    names = sorted(os.listdir(jax))
    assert sorted(os.listdir(port)) == names and len(names) == 2
    for n in names:
        _within_bound(read_ppm(str(port / n)), read_ppm(str(jax / n)))


@pytest.mark.parametrize("dims", ["48x32", "80x72"])
def test_resize_matches(inputs, tmp_path, capsys, dims):
    port, jax = _both(["resize", inputs["img"], "{out}/r.ppm", dims],
                      tmp_path, capsys)
    _same_files(port, jax)


def test_dump_stages_and_compare_dirs_match(inputs, tmp_path, capsys):
    port, jax = _both(["dump-stages", inputs["img"], "{out}/parts",
                       "--quality", "90"], tmp_path, capsys)
    # the port's own compare-dirs holds the two dump directories equal
    capsys.readouterr()
    assert port_main(["compare-dirs", str(port / "parts"),
                      str(jax / "parts")]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 15
    (port / "parts" / "Y-Dct").write_text("0\n")
    for a, b in ((jax, jax), (port, jax)):
        _both(["compare-dirs", str(a / "parts"), str(b / "parts")],
              tmp_path, capsys)


def test_diff_matches(inputs, tmp_path, capsys):
    img = read_ppm(inputs["img"])
    new = img.copy()
    new[8:40, 8:40] = 255 - new[8:40, 8:40]
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    write_ppm(a, img)
    write_ppm(b, new)
    port, jax = _both(["diff", a, b, "{out}/regions"], tmp_path, capsys)
    _same_files(port / "regions", jax / "regions")
    assert sorted(os.listdir(port / "regions"))[0] == "jpg-0"
    port, jax = _both(["diff", a, a, "{out}/quiet"], tmp_path, capsys)
    assert os.listdir(port / "quiet") == os.listdir(jax / "quiet") == []


def test_cli_needs_the_card_by_default(inputs, tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["encode", inputs["img"], str(tmp_path / "x.jpg")])


def test_module_runs_as_a_program(inputs, tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "jpeg_tpu_torch", "--device", "cpu", "resize",
         inputs["img"], str(tmp_path / "r.ppm"), "16x16"],
        cwd=root, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout == f"{tmp_path / 'r.ppm'}: 16x16\n"
