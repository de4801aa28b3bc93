"""Command-line interface mirroring the reference's host tools (the port of
``jpeg_tpu/__main__.py``: the same seven subcommands, options, output
files and printed lines).

  python -m jpeg_tpu_torch [--device {cuda,cpu}] <subcommand> ...

  encode in.ppm out.jpg [--quality N] [--interleaved] [--fixed]
                        [--restart N] [--subsampling S] [--gray]
                        [--progressive] [--successive]
      U1 analog (``original <ppm> <quality>``, utils/original.c:1135-1141).
  decode in.jpg out.ppm [--host] [--entropy E]
      completes the stub decode path (utils/func_tester.c:1262).
  decode-batch in1.jpg in2.jpg ... --outdir DIR
      batch decode: one kernel G launch for all restart inputs.
  resize in.ppm out.ppm WxH
      U5 analog (``editimage``, crop/white-pad).
  dump-stages in.ppm outdir [--quality N]
      U3 analog (func_tester myParts dumps).
  compare-dirs dirA dirB
      U4 analog (dir-compare).
  diff old.ppm new.ppm outdir
      F1/F2 analog: difference regions of two frames, one JPEG each.

``--device`` (default ``cuda``) is where the encoders, the decoder and the
monitor run: the card's kernels, or with ``cpu`` their plain twins.
Without a card the default raises; nothing falls back to the CPU.  The
reference's persistent compile cache set-up (``JAX_COMPILATION_CACHE_DIR``)
is dropped: the port has no JIT cache to keep; it builds its kernels once
per source hash into ``jpeg_tpu_torch/_build``.
"""
from __future__ import annotations

import argparse
import os
import sys


def _cfg(args):
    from .core.types import EncodeConfig
    kw = {}
    if getattr(args, "quality", None) is not None:
        kw["quality"] = args.quality
    if getattr(args, "interleaved", False) or getattr(args, "restart", 0):
        kw["scan_layout"] = "interleaved"
    if getattr(args, "fixed", False):
        kw["huffman"] = "fixed"
    if getattr(args, "restart", 0):
        kw["restart_interval_mcu_rows"] = args.restart
    if getattr(args, "subsampling", None):
        kw["subsampling"] = args.subsampling
    return EncodeConfig(**kw)


def _host(img):
    """A decoded image as [H, W, 3] uint8 numpy (gray replicated into RGB
    for PPM P6)."""
    import numpy as np
    out = img.cpu().numpy() if hasattr(img, "cpu") else np.asarray(img)
    if out.ndim == 2:
        out = np.stack([out] * 3, axis=-1)
    return out


def cmd_encode(args):
    from .io.ppm import read_ppm
    from .pipelines.encode import JpegEncoder, encode_gray
    from .utils.profiling import encode_metrics
    img = read_ppm(args.input)
    if args.gray:
        y = (0.299 * img[..., 0] + 0.587 * img[..., 1]
             + 0.114 * img[..., 2]).astype("uint8")
        data = encode_gray(y, _cfg(args), device=args.device)
        with open(args.output, "wb") as f:
            f.write(data)
        print(f"{args.output}: {len(data)} bytes (grayscale)")
        return
    if args.progressive or args.successive:
        from .pipelines.progressive import encode_progressive
        data = encode_progressive(img, _cfg(args), successive=args.successive,
                                  device=args.device)
        with open(args.output, "wb") as f:
            f.write(data)
        kind = "progressive+SA" if args.successive else "progressive"
        print(f"{args.output}: {len(data)} bytes ({kind})")
        return
    data = JpegEncoder(_cfg(args), device=args.device).encode_any(img)
    with open(args.output, "wb") as f:
        f.write(data)
    m = encode_metrics(img, data)
    print(f"{args.output}: {m['bytes']} bytes, {m['bpp']:.3f} bpp, "
          f"PSNR {m['psnr_db']:.2f} dB")


def cmd_decode(args):
    from .io.ppm import write_ppm
    with open(args.input, "rb") as f:
        data = f.read()
    if args.host:
        from .golden.decoder import decode as dec
        out = dec(data)
    else:
        from .pipelines.decode import decode_jpeg
        out = decode_jpeg(data, entropy_engine=args.entropy,
                          device=args.device)
    write_ppm(args.output, _host(out))
    print(f"{args.output} written")


def cmd_decode_batch(args):
    from .io.ppm import write_ppm
    from .pipelines.decode import decode_jpeg_batch
    datas = []
    for path in args.inputs:
        with open(path, "rb") as f:
            datas.append(f.read())
    outs = decode_jpeg_batch(datas, entropy_engine=args.entropy,
                             device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    for path, out in zip(args.inputs, outs):
        dst = os.path.join(
            args.outdir,
            os.path.splitext(os.path.basename(path))[0] + ".ppm")
        write_ppm(dst, _host(out))
        print(f"{dst} written")


def cmd_resize(args):
    from .io.editimage import resize_pad
    from .io.ppm import read_ppm, write_ppm
    w, h = (int(v) for v in args.dims.lower().split("x"))
    write_ppm(args.output, resize_pad(read_ppm(args.input), w, h))
    print(f"{args.output}: {w}x{h}")


def cmd_dump_stages(args):
    from .io.ppm import read_ppm
    from .utils.stage_dump import dump_stages
    dump_stages(read_ppm(args.input), args.outdir, quality=args.quality)
    print(f"stage dumps written to {args.outdir}")


def cmd_compare_dirs(args):
    from .utils.dir_compare import main as dc_main
    return dc_main([args.dir_a, args.dir_b])


def cmd_diff(args):
    from .io.ppm import read_ppm
    from .pipelines.monitor import ChangeMonitor
    old = read_ppm(args.old)
    new = read_ppm(args.new)
    h, w = old.shape[:2]
    mon = ChangeMonitor(h, w, device=args.device)
    mon.process_frame(old)
    res = mon.process_frame(new)
    os.makedirs(args.outdir, exist_ok=True)
    for i, (area, data) in enumerate(res.regions):
        path = os.path.join(args.outdir, f"jpg-{i}")  # main/main.c:149-151
        with open(path, "wb") as f:
            f.write(data)
        print(f"{path}: region x={area.x} y={area.y} {area.w}x{area.h}, "
              f"{len(data)} bytes")
    if not res.regions:
        print("no differences found")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jpeg_tpu_torch")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="run on the card's kernels (cuda) or their plain "
                        "PyTorch twins (cpu)")
    sub = p.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("encode")
    e.add_argument("input"); e.add_argument("output")
    e.add_argument("--quality", type=int, default=None)
    e.add_argument("--interleaved", action="store_true")
    e.add_argument("--fixed", action="store_true")
    e.add_argument("--restart", type=int, default=0,
                   help="restart interval in MCU rows (implies interleaved)")
    e.add_argument("--subsampling", choices=["420", "422", "444"], default=None)
    e.add_argument("--gray", action="store_true",
                   help="encode as single-component grayscale")
    e.add_argument("--progressive", action="store_true",
                   help="progressive (SOF2) spectral-selection stream")
    e.add_argument("--successive", action="store_true",
                   help="progressive with successive approximation "
                        "(10-scan script)")
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode")
    d.add_argument("input"); d.add_argument("output")
    d.add_argument("--host", action="store_true",
                   help="use the f64 host decoder instead of the device path")
    d.add_argument("--entropy", choices=["auto", "host", "device"],
                   default="auto",
                   help="Huffman bit-walk engine: device = kernel G, a warp "
                        "a lane (restart streams; others speculatively)")
    d.set_defaults(fn=cmd_decode)

    db = sub.add_parser("decode-batch")
    db.add_argument("inputs", nargs="+")
    db.add_argument("--outdir", required=True)
    db.add_argument("--entropy", choices=["auto", "host", "device"],
                    default="auto")
    db.set_defaults(fn=cmd_decode_batch)

    r = sub.add_parser("resize")
    r.add_argument("input"); r.add_argument("output"); r.add_argument("dims")
    r.set_defaults(fn=cmd_resize)

    s = sub.add_parser("dump-stages")
    s.add_argument("input"); s.add_argument("outdir")
    s.add_argument("--quality", type=int, default=None)
    s.set_defaults(fn=cmd_dump_stages)

    c = sub.add_parser("compare-dirs")
    c.add_argument("dir_a"); c.add_argument("dir_b")
    c.set_defaults(fn=cmd_compare_dirs)

    f = sub.add_parser("diff")
    f.add_argument("old"); f.add_argument("new"); f.add_argument("outdir")
    f.set_defaults(fn=cmd_diff)

    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
