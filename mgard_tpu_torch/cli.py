"""Command-line interface (the port of ``mgard_tpu/cli.py``; counterpart
of the reference `mgard` and `mgard-x` executables,
src/cli/executable.cpp:13-50 and
src/mgard-x/Executables/mgard-x.cpp:336-411).

Usage:
    python -m mgard_tpu_torch compress   -i in.bin -o out.mgardtpu \
        --shape 512 512 512 --dtype float32 --tolerance 1e-3 [--smoothness S]
        [--mode abs|rel] [--lossless bitplane|bitplane-zstd|bitplane-lz4]
    python -m mgard_tpu_torch decompress -i in.mgardtpu -o out.bin
    python -m mgard_tpu_torch inspect    -i in.mgardtpu

Every subcommand runs on the card unless ``--device`` names another
device (``--device cpu``: the plain PyTorch versions on the CPU); without
a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np


def _build_parser():
    p = argparse.ArgumentParser(prog="mgard-tpu")
    sub = p.add_subparsers(dest="command", required=True)
    # the port's API takes a device; the flag goes on every subcommand
    dev = argparse.ArgumentParser(add_help=False)
    dev.add_argument("--device", default=None,
                     help="torch device to run on (default: the CUDA card; "
                     "'cpu' runs the plain PyTorch versions)")

    c = sub.add_parser("compress", help="compress a raw binary array",
                       parents=[dev])
    c.add_argument("--input", "-i", required=True)
    c.add_argument("--output", "-o", required=True)
    c.add_argument("--shape", nargs="+", type=int, required=True)
    c.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    c.add_argument("--tolerance", "-e", type=float, required=True)
    c.add_argument("--smoothness", "-s", type=float, default=math.inf,
                   help="s-norm parameter; inf = L-infinity (default)")
    c.add_argument("--mode", "-m", choices=["abs", "rel"], default="abs")
    c.add_argument("--lossless", "-l",
                   choices=["bitplane", "bitplane-zstd", "bitplane-lz4"],
                   default="bitplane")
    c.add_argument("--format", choices=["native", "mgard", "mgard-x"],
                   default="native",
                   help="container format: native .mgardtpu (default), "
                        "reference CPU `mgard`, or `mgard-x` serial")

    d = sub.add_parser("decompress", help="decompress a .mgardtpu container",
                       parents=[dev])
    d.add_argument("--input", "-i", required=True)
    d.add_argument("--output", "-o", required=True)

    s = sub.add_parser("inspect", help="print container header",
                       parents=[dev])
    s.add_argument("--input", "-i", required=True)

    # MDR (counterpart of the reference `mdr-x` executable,
    # src/mgard-x/Executables/mdr-x.cpp:443-502)
    r = sub.add_parser("refactor", help="MDR: refactor into bitplanes",
                       parents=[dev])
    r.add_argument("--input", "-i", required=True)
    r.add_argument("--output", "-o", required=True,
                   help="output directory for metadata + streams")
    r.add_argument("--shape", nargs="+", type=int, required=True)
    r.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")

    rc = sub.add_parser("reconstruct",
                        help="MDR: progressive reconstruct to a tolerance",
                        parents=[dev])
    rc.add_argument("--input", "-i", required=True,
                    help="directory produced by `refactor` (or by the "
                    "reference `mdr-x -z` with --format mdr-x)")
    rc.add_argument("--output", "-o", required=True)
    rc.add_argument("--tolerance", "-e", type=float, required=True)
    rc.add_argument("--smoothness", "-s", type=float, default=math.inf)
    rc.add_argument("--format", choices=["native", "mdr-x"],
                    default="native",
                    help="mdr-x = read the reference tool's refactored "
                    "directory layout (io/mdrx_compat.py)")

    z = sub.add_parser("zfp", help="fixed-rate (ZFP-style) compress",
                       parents=[dev])
    z.add_argument("--input", "-i", required=True)
    z.add_argument("--output", "-o", required=True)
    z.add_argument("--shape", nargs="+", type=int, required=True)
    z.add_argument("--dtype", choices=["float32", "float64"],
                   default="float32")
    z.add_argument("--rate", type=int, default=8)
    z.add_argument("--format", choices=["native", "zfp-x"],
                   default="native",
                   help="native = the lifting codec container; zfp-x = "
                   "the reference port's raw fixed-rate stream "
                   "(bit-compatible, models/zfp_stream.py)")
    z.add_argument("--zfp-strides", choices=["reference", "correct"],
                   default="reference",
                   help="zfp-x only: 'reference' matches the port's "
                   "bytes exactly (its ld-as-stride addressing covers "
                   "only part of a 3-D array); 'correct' is true "
                   "row-major zfp layout")

    zd = sub.add_parser("zfp-decompress", help="decode a ZFPT stream",
                        parents=[dev])
    zd.add_argument("--input", "-i", required=True)
    zd.add_argument("--output", "-o", required=True)
    zd.add_argument("--format", choices=["native", "zfp-x"],
                    default="native")
    zd.add_argument("--shape", nargs="+", type=int,
                    help="required for --format zfp-x (raw streams are "
                    "headerless)")
    zd.add_argument("--dtype", choices=["float32", "float64"],
                    default="float32")
    zd.add_argument("--rate", type=int, default=8)
    zd.add_argument("--zfp-strides", choices=["reference", "correct"],
                    default="reference")
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)
    from .api import resolve_device
    device = args.device
    resolve_device(device)      # no card and no --device cpu: raise here

    if args.command == "compress":
        import mgard_tpu_torch as mt
        from .config import Config, Lossless

        data = np.fromfile(args.input, dtype=np.dtype(args.dtype))
        n_expected = int(np.prod(args.shape))
        if data.size != n_expected:
            sys.exit(f"error: file has {data.size} elements, "
                     f"shape needs {n_expected}")
        data = data.reshape(args.shape)
        if args.format in ("mgard", "mgard-x"):
            # interop writers take an absolute tolerance
            tol = args.tolerance
            if args.mode == "rel":
                tol = tol * float(np.abs(data).max())
            from .io import mgard_compat
            if args.format == "mgard":
                buf = mgard_compat.compress_mgard(data, tol,
                                                  s=args.smoothness,
                                                  device=device)
            else:
                buf = mgard_compat.compress_mgard_x(data, args.tolerance,
                                                    s=args.smoothness,
                                                    mode=args.mode,
                                                    device=device)
        else:
            lossless = {"bitplane": Lossless.BITPLANE,
                        "bitplane-zstd": Lossless.BITPLANE_ZSTD,
                        "bitplane-lz4": Lossless.BITPLANE_LZ4,
                        }[args.lossless]
            buf = mt.compress(data, args.tolerance, s=args.smoothness,
                              mode=args.mode,
                              config=Config(lossless=lossless),
                              device=device)
        with open(args.output, "wb") as f:
            f.write(buf)
        print(f"{data.nbytes} -> {len(buf)} bytes "
              f"(ratio {data.nbytes / len(buf):.2f}x)")
    elif args.command == "decompress":
        import mgard_tpu_torch as mt

        with open(args.input, "rb") as f:
            buf = f.read()
        out = mt.decompress(buf, device=device)
        out.tofile(args.output)
        print(f"wrote {out.nbytes} bytes, shape {out.shape}, {out.dtype}")
    elif args.command == "refactor":
        import pathlib

        from .hierarchy import Hierarchy
        from .models import mdr

        data = np.fromfile(args.input, dtype=np.dtype(args.dtype))
        data = data.reshape(args.shape)
        hier = Hierarchy(data.shape)
        res = mdr.mdr_refactor(hier, data, device=device)
        outdir = pathlib.Path(args.output)
        outdir.mkdir(parents=True, exist_ok=True)
        (outdir / "metadata.bin").write_bytes(res.metadata.pack())
        total = 0
        for l, streams in enumerate(res.streams):
            for k, s_ in enumerate(streams):
                (outdir / f"level{l}_stream{k}.bin").write_bytes(s_)
                total += len(s_)
        print(f"refactored {data.nbytes} bytes into {total} stream bytes "
              f"({len(res.streams)} levels)")
    elif args.command == "reconstruct":
        import pathlib

        from .hierarchy import Hierarchy
        from .models import mdr

        if args.format == "mdr-x":
            if not math.isinf(args.smoothness):
                sys.exit("error: --format mdr-x reconstructs to an "
                         "L-inf (MaxError-model) tolerance only; "
                         "finite --smoothness is not supported")
            from .io.mdrx_compat import mdrx_reconstruct
            out = mdrx_reconstruct(args.input, tol=args.tolerance,
                                   device=device)
            out.tofile(args.output)
            print(f"reconstructed {out.nbytes} bytes (mdr-x artifact), "
                  f"shape {out.shape}")
            return
        indir = pathlib.Path(args.input)
        md = mdr.MDRMetadata.unpack((indir / "metadata.bin").read_bytes())
        hier = Hierarchy(md.shape)
        counts = mdr.mdr_request(md, args.tolerance, args.smoothness)
        rec = mdr.MDReconstructor(hier, md, device=device)
        fetched = 0
        for l, c in enumerate(counts):
            streams = {0: (indir / f"level{l}_stream0.bin").read_bytes()}
            for b in range(c):
                s_ = (indir / f"level{l}_stream{1+b}.bin").read_bytes()
                streams[1 + b] = s_
                fetched += len(s_)
            rec.add_streams(l, streams)
        out = rec.reconstruct(counts)
        out.astype(md.dtype).tofile(args.output)
        print(f"reconstructed {out.nbytes} bytes from {fetched} stream "
              f"bytes (planes per level: {counts})")
    elif args.command == "zfp":
        data = np.fromfile(args.input, dtype=np.dtype(args.dtype))
        data = data.reshape(args.shape)
        if args.format == "zfp-x":
            from .models.zfp_stream import zfp_encode
            buf = zfp_encode(data, args.rate, strides=args.zfp_strides)
        else:
            from .models.zfp import compress_zfp
            buf = compress_zfp(data, rate=args.rate, device=device)
        with open(args.output, "wb") as f:
            f.write(buf)
        print(f"{data.nbytes} -> {len(buf)} bytes "
              f"(fixed rate {args.rate} bits/value)")
    elif args.command == "zfp-decompress":
        with open(args.input, "rb") as f:
            buf = f.read()
        if args.format == "zfp-x":
            if not args.shape:
                raise SystemExit("--format zfp-x needs --shape (raw "
                                 "zfp streams are headerless)")
            from .models.zfp_stream import zfp_decode
            out = zfp_decode(buf, tuple(args.shape), np.dtype(args.dtype),
                             args.rate, strides=args.zfp_strides)
        else:
            from .models.zfp import decompress_zfp
            out = decompress_zfp(buf, device=device)
        out.tofile(args.output)
        print(f"wrote {out.nbytes} bytes, shape {out.shape}")
    elif args.command == "inspect":
        from .io import format as fmt

        with open(args.input, "rb") as f:
            buf = f.read()
        header, sections = fmt.read_container(buf)
        print(f"dtype       : {header.dtype}")
        print(f"shape       : {header.shape}")
        print(f"uniform grid: {header.uniform}")
        print(f"error mode  : {'abs' if header.error_mode == 0 else 'rel'}")
        print(f"s           : {header.s}")
        print(f"tolerance   : {header.tolerance}")
        print(f"norm        : {header.norm}")
        print(f"lossless    : {header.lossless}")
        print(f"levels      : {header.n_levels}")
        print(f"sections    : {list(header.section_sizes)} bytes")


if __name__ == "__main__":
    main()
