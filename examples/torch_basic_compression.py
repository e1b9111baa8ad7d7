"""Basic error-bounded compression with mgard_tpu_torch (the port's
counterpart of ``examples/basic_compression.py``, itself of the reference
examples/compression and examples/decompression samples).

    python examples/torch_basic_compression.py [--n 129] [--device cuda]

Compresses a smooth n^3 float32 field three ways: an absolute L-infinity
bound, a relative s-norm bound (s = 0, the L2 function norm), and an
absolute bound on a nonuniform grid.  Raises if an error exceeds its
bound.
"""

import argparse

import numpy as np
import torch

import mgard_tpu_torch as mt
from mgard_tpu_torch.io import format as fmt
from mgard_tpu_torch.ops import norms


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=129, help="points per dim")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device

    x = np.linspace(0, 1, args.n)
    v = (np.sin(4 * np.pi * x)[:, None, None]
         * np.cos(2 * np.pi * x)[None, :, None]
         * np.exp(-x)[None, None, :]).astype(np.float32)

    # Absolute L-infinity bound
    buf = mt.compress(v, tolerance=1e-3, device=dev)
    out = mt.decompress(buf, device=dev)
    err = np.abs(out - v).max()
    print(f"L-inf  : {v.nbytes} -> {len(buf)} bytes "
          f"({v.nbytes / len(buf):.1f}x), max err {err:.2e}")
    if not err <= 1e-3:
        raise AssertionError(f"L-inf error {err} exceeds 1e-3")

    # Relative s-norm bound (s=0 is the L2 function norm); the container
    # records the absolute bound, 1e-4 times the field's norm
    buf = mt.compress(v, tolerance=1e-4, s=0.0, mode="rel", device=dev)
    out = mt.decompress(buf, device=dev)
    bound = fmt.read_container(buf)[0].tolerance
    diff = torch.from_numpy(out.astype(np.float64) - v).to(dev)
    err = float(norms.norm(mt.Hierarchy(v.shape), diff, 0.0))
    print(f"L2 rel : {v.nbytes} -> {len(buf)} bytes "
          f"({v.nbytes / len(buf):.1f}x), ||err||_0 {err:.2e} <= "
          f"{bound:.2e}")
    if not err <= bound:
        raise AssertionError(f"s = 0 error {err} exceeds {bound}")

    # Nonuniform grid
    coords = [np.sort(np.random.default_rng(0).uniform(0, 1, s))
              for s in v.shape]
    buf = mt.compress(v, 1e-3, coordinates=coords, device=dev)
    out = mt.decompress(buf, device=dev)
    err = np.abs(out - v).max()
    print(f"nonuni : max err {err:.2e} <= 1e-3")
    if not err <= 1e-3:
        raise AssertionError(f"nonuniform error {err} exceeds 1e-3")


if __name__ == "__main__":
    main()
