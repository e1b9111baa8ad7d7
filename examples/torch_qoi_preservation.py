"""Quantity-of-interest preservation with mgard_tpu_torch (the port's
counterpart of ``examples/qoi_preservation.py``, itself of the reference
examples/qoi).

    python examples/torch_qoi_preservation.py [--n 65] [--device cuda]

Compresses a smooth n x n float64 field so that its mean, a linear
functional, moves by at most the tolerance.  Raises if it moves more.
"""

import argparse

import numpy as np
import torch

import mgard_tpu_torch as mt
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models.qoi import QuantityOfInterest, compress_qoi


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=65, help="points per dim")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device

    x = np.linspace(0, 1, args.n)
    v = np.outer(np.sin(3 * x), np.cos(2 * x))

    h = Hierarchy(v.shape)
    # any linear functional of a float64 tensor on the device
    qoi = QuantityOfInterest(h, lambda u: torch.mean(u), device=dev)
    print(f"||Q||_0 operator norm: {qoi.norm(0.0):.4f}")

    tol = 1e-6
    buf = compress_qoi(v, qoi, tol, s=0.0, device=dev)
    out = mt.decompress(buf, device=dev)
    drift = abs(v.mean() - out.mean())
    print(f"QoI drift: {drift:.2e} <= {tol:.0e} "
          f"(ratio {v.nbytes / len(buf):.1f}x)")
    if not drift <= tol:
        raise AssertionError(f"QoI drift {drift} exceeds {tol}")


if __name__ == "__main__":
    main()
