"""Progressive retrieval with MDR through mgard_tpu_torch (the port's
counterpart of ``examples/progressive_mdr.py``, itself of the reference
mdr-x refactor/reconstruct tool, src/mgard-x/Executables/mdr-x.cpp).

    python examples/torch_progressive_mdr.py [--n 65] [--device cuda]

Refactors a smooth n x n float64 field once, then retrieves it at
tighter and tighter tolerances, fetching only the bitplanes each step
adds.  The streams are zstd-compressed where ``zstandard`` imports, else
stored raw.  Raises if an error exceeds its tolerance.
"""

import argparse

import numpy as np

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models import mdr


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=65, help="points per dim")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    try:
        import zstandard  # noqa: F401
        lossless = mdr.LOSSLESS_ZSTD
    except ModuleNotFoundError:
        lossless = mdr.LOSSLESS_NONE
    print(f"streams: {'zstd' if lossless else 'raw (no zstandard)'}")

    x = np.linspace(0, 1, args.n)
    v = np.sin(2 * np.pi * x)[:, None] * np.cos(np.pi * x)[None, :]

    h = Hierarchy(v.shape)
    # Refactor once...
    res = mdr.mdr_refactor(h, v, lossless=lossless, device=dev)

    # ...retrieve progressively at successively tighter tolerances,
    # fetching only the additional bitplanes each time.
    rec = mdr.MDReconstructor(h, res.metadata, device=dev)
    fetched = [0] * len(res.metadata.levels)
    for tol in (1e-1, 1e-3, 1e-5):
        counts = mdr.mdr_request(res.metadata, tol)
        nbytes = 0
        for l, c in enumerate(counts):
            streams = {0: res.streams[l][0]}
            for b in range(fetched[l], c):
                streams[1 + b] = res.streams[l][1 + b]
                nbytes += len(res.streams[l][1 + b])
            rec.add_streams(l, streams)
        fetched = [max(a, b) for a, b in zip(fetched, counts)]
        out = rec.reconstruct(counts)
        err = np.abs(out - v).max()
        print(f"tol {tol:.0e}: fetched {nbytes:6d} more bytes, "
              f"err {err:.2e}")
        if not err <= tol:
            raise AssertionError(f"MDR at {tol}: error {err}")


if __name__ == "__main__":
    main()
