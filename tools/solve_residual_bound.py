#!/usr/bin/env python3
"""The residual that mgard_tpu_torch's plain Thomas solve leaves at 2^20 + 1
nodes, the basis of ``SOLVE_RESIDUAL_BOUND`` in ``chip_smoke.py``.

    python3 tools/solve_residual_bound.py

Runs ``ops/tridiag.py``'s ``mass_solve_plain`` on the CPU, in float32, on
a uniform 1-D grid of 2^20 + 1 nodes, for a normal and a smooth right-hand
side from seed 0, and prints ``max|M x - b| / max|b|`` in float64 for each
(about a minute).  The chip check holds S1 to 8x the larger of the two on
solves too long for the plain version to run there.
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mgard_tpu_torch.hierarchy import Hierarchy  # noqa: E402
from mgard_tpu_torch.ops import tridiag  # noqa: E402


def main() -> None:
    n = (1 << 20) + 1
    lev = Hierarchy((n,)).dims[0][-1]
    rng = np.random.default_rng(0)
    cases = {
        "normal": rng.standard_normal(n),
        "smooth": np.cos(np.linspace(0, 30, n)) * 1e-3
        + 1e-6 * rng.standard_normal(n),
    }
    for name, b in cases.items():
        t0 = time.perf_counter()
        bt = torch.from_numpy(b.astype(np.float32))
        x = tridiag.mass_solve_plain(bt, lev.offdiag, lev.divisors, 0)
        r = tridiag.mass_apply(x.double(), lev.h, 0) - bt.double()
        print(f"{name}: max|M x - b| / max|b| = "
              f"{float(r.abs().max() / bt.double().abs().max())!r} "
              f"({time.perf_counter() - t0:.1f} s)")


if __name__ == "__main__":
    main()
