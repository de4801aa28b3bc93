"""Golden-directory comparator (the reference's ``utils/dir-compare.c``).

The port's own copy of ``jpeg_tpu.utils.dir_compare``.

Pairs same-named files in two directories and byte-compares them,
reporting per-file match/mismatch — the reference's test tool for its
stage dumps (``utils/dir-compare.c:9-90``).  Importable API plus a small
CLI (``python -m jpeg_tpu_torch.utils.dir_compare A B``).
"""
from __future__ import annotations

import os
import sys


def compare_dirs(a: str, b: str) -> dict[str, bool]:
    """{filename: files_are_byte_identical} over names present in both."""
    names = sorted(set(os.listdir(a)) & set(os.listdir(b)))
    out = {}
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if not (os.path.isfile(pa) and os.path.isfile(pb)):
            continue
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            out[n] = fa.read() == fb.read()
    return out


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m jpeg_tpu_torch.utils.dir_compare "
              "<dirA> <dirB>")
        return 2
    results = compare_dirs(argv[0], argv[1])
    bad = 0
    for name, ok in results.items():
        # cyan for match, red for mismatch, like the reference tool
        color = "\033[36m" if ok else "\033[31m"
        print(f"{color}{name}\033[0m")
        bad += not ok
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
