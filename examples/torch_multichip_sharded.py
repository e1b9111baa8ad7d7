"""Data-parallel compression over the visible CUDA devices with
mgard_tpu_torch (the port's counterpart of
``examples/multichip_sharded.py``, which shards over a JAX mesh; the
reference scales through MPI + ADIOS2 at the application level,
doc/MGARD-X.md:285).

    python examples/torch_multichip_sharded.py [--edge 33] [--device cuda]

One block of edge^3 a device: ``ShardedCompressor`` places the blocks on
the devices in contiguous runs and runs the single-device pipeline on
each.  ``--device cuda`` takes every visible card, any other value that
one device (``cpu``: the plain PyTorch versions).  Raises if an error
exceeds its bound.
"""

import argparse

import numpy as np
import torch

from mgard_tpu_torch.parallel import ShardedCompressor


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--edge", type=int, default=33, help="block edge")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    devices = None if args.device == "cuda" else [args.device]

    block_shape = (args.edge,) * 3
    sc = ShardedCompressor(devices, block_shape, np.float32)
    nblocks = len(sc.devices)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(nblocks, *block_shape)).astype(np.float32)

    e, w, counts, statuses, block_tol = sc.encode(v, 1e-2)
    sizes = [int(c) for c in counts]
    print(f"{nblocks} devices ({', '.join(map(str, sc.devices))}), "
          f"per-block words: {sizes}")
    out = torch.stack([b.cpu() for b in sc.decode(e, w, block_tol)])
    err = float((out - torch.from_numpy(v)).abs().max())
    print(f"max err {err:.2e} <= 1e-2")
    if not err <= 1e-2:
        raise AssertionError(f"sharded error {err} exceeds 1e-2")


if __name__ == "__main__":
    main()
