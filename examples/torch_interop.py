"""Interop with the reference MGARD implementations through
mgard_tpu_torch (the port's counterpart of ``examples/interop.py``).

    python examples/torch_interop.py [--n 33] [--device cuda]

Writes and reads back, on a smooth n^3 field:

* CPU-format ``MGARD`` buffers (Huffman, then zstd where ``zstandard``
  imports, else zlib);
* ``mgard-x`` buffers at L-infinity ABS, s = 0 and REL (X-Huffman, then
  zstd where it imports);
* the reference port's ZFP fixed-rate streams (``strides="correct"``,
  the row-major layout).

``mgard_tpu_torch.decompress`` reads each container by its magic.
``mdr-x`` directories written by the reference tool read with
``mgard_tpu_torch.io.mdrx_compat.mdrx_reconstruct(dir, tol=...)``.
Raises if an error exceeds its bound.
"""

import argparse

import numpy as np
import torch

import mgard_tpu_torch as mt
from mgard_tpu_torch.io import mgard_compat
from mgard_tpu_torch.models.zfp_stream import (zfp_decode, zfp_encode,
                                               zfp_stream_bytes)
from mgard_tpu_torch.ops import norms


def _has_zstd() -> bool:
    try:
        import zstandard  # noqa: F401
    except ModuleNotFoundError:
        return False
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=33,
                   help="points per dim (2^k + 1 for mgard-x)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    zstd = _has_zstd()
    print(f"second stage: {'zstd' if zstd else 'zlib / none (no zstandard)'}")

    x = np.linspace(0, 1, args.n)
    v = (np.sin(3 * x)[:, None, None] * np.cos(2 * x)[None, :, None]
         * (1 + x)[None, None, :]).astype(np.float64)

    # --- reference CPU format ---------------------------------------------
    buf = mgard_compat.compress_mgard(v, 1e-4, zstd=zstd, device=dev)
    out = mt.decompress(buf, device=dev)            # magic-dispatched
    err = np.abs(out - v).max()
    print(f"CPU format: {v.nbytes} -> {len(buf)} bytes, err {err:.2e}")
    if not err <= 1e-4:
        raise AssertionError(f"CPU format error {err} exceeds 1e-4")

    # --- mgard-x format ---------------------------------------------------
    v32 = v.astype(np.float32)
    hier = mt.Hierarchy(v32.shape)
    for kwargs in (dict(), dict(s=0.0), dict(mode="rel")):
        xbuf = mgard_compat.compress_mgard_x(v32, 1e-3, zstd=zstd,
                                             device=dev, **kwargs)
        xout = mt.decompress(xbuf, device=dev)      # same entry point
        diff = xout.astype(np.float64) - v32
        if "s" in kwargs:
            err = float(norms.norm(hier, torch.from_numpy(diff).to(dev),
                                   0.0))
            bound = 1e-3
        else:
            err = np.abs(diff).max()
            bound = 1e-3 * (np.abs(v32).max() if kwargs else 1.0)
        print(f"mgard-x {kwargs or '{L-inf abs}'}: {len(xbuf)} bytes, "
              f"err {err:.2e} <= {bound:.2e}")
        if not err <= bound:
            raise AssertionError(f"mgard-x {kwargs}: error {err} exceeds "
                                 f"{bound}")

    # --- ZFP fixed-rate streams -------------------------------------------
    rate = 12
    # strides="reference" reproduces the reference port's bytes (its
    # ld-as-stride addressing covers only a sliver of a 3-D array, see
    # models/zfp_stream.py); "correct" is the row-major zfp layout
    zbuf = zfp_encode(v32, rate, strides="correct")
    zout = zfp_decode(zbuf, v32.shape, np.float32, rate, strides="correct")
    err = np.abs(zout - v32).max()
    print(f"zfp rate {rate}: {len(zbuf)} bytes, err {err:.2e}")
    # a fixed rate bounds the size, not the error: the stream is the
    # rate's bytes, and this smooth field keeps ~2^-(rate - 4) of its
    # range
    if len(zbuf) != zfp_stream_bytes(v32.shape, rate) \
            or not err <= 2.0 ** -(rate - 4) * np.abs(v32).max():
        raise AssertionError(f"zfp: {len(zbuf)} bytes, error {err}")

    print("mdr-x artifacts: mgard_tpu_torch.io.mdrx_compat.mdrx_reconstruct"
          "(dir, tol=...); see tests/test_torch_mdrx.py")


if __name__ == "__main__":
    main()
