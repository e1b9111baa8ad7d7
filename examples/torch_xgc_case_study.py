"""XGC-style fusion-data case study with mgard_tpu_torch (the port's
counterpart of ``examples/xgc_case_study.py``, itself of the reference's
examples/xgc-casestudy: 4-D nonuniform / 5-D temporal XGC workflows).

    python examples/torch_xgc_case_study.py [edge_scale] [--device cuda]

Compresses a synthetic gyrokinetic distribution-function snapshot
f(phi, node, vpara, vperp), the XGC "f0" layout with a nonuniform
velocity grid and 1024 * edge_scale mesh nodes, three ways:

  1. error-bounded one-shot compression at several tolerances,
  2. relative-bound compression (the mode XGC pipelines use),
  3. MDR refactor + progressive retrieval at decreasing tolerances
     (the HPDR IPDPS'25 workflow: store once, read the bytes each
     analysis needs).

The one-shot compressions take BITPLANE_ZSTD, and MDR zstd streams,
where ``zstandard`` imports; otherwise BITPLANE_LZ4 and raw streams.
Raises if an error exceeds its bound.
"""

import argparse
import time

import numpy as np

import mgard_tpu_torch as mt
from mgard_tpu_torch.config import Config, Lossless
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models import mdr


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("edge_scale", nargs="?", type=float, default=1,
                   help="mesh nodes = 1024 * edge_scale")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    try:
        import zstandard  # noqa: F401
        lossless, mdr_lossless = Lossless.BITPLANE_ZSTD, mdr.LOSSLESS_ZSTD
    except ModuleNotFoundError:
        lossless, mdr_lossless = Lossless.BITPLANE_LZ4, mdr.LOSSLESS_NONE
    print(f"lossless: {lossless.name}, MDR streams "
          f"{'zstd' if mdr_lossless else 'raw'}")

    # Synthetic f0-like snapshot: (n_phi planes, mesh nodes, v_para,
    # v_perp).  Maxwellian-ish in velocity, smooth poloidal structure,
    # multiscale noise.
    n_phi, n_node, n_vpa, n_vpe = 8, int(1024 * args.edge_scale), 33, 17
    rng = np.random.default_rng(0)
    theta = np.linspace(0, 2 * np.pi, n_node, endpoint=False)
    # nonuniform velocity grids (denser near v=0, like XGC's)
    vpa = np.sign(np.linspace(-1, 1, n_vpa)) * np.linspace(-1, 1, n_vpa) ** 2
    vpe = np.linspace(0, 1, n_vpe) ** 1.5

    f = (np.exp(-(vpa[None, None, :, None] ** 2) * 3
                - (vpe[None, None, None, :] ** 2) * 2)
         * (1.0 + 0.3 * np.sin(theta)[None, :, None, None]
            + 0.05 * np.cos(3 * theta)[None, :, None, None]
            * np.linspace(0.8, 1.2, n_phi)[:, None, None, None]))
    f = (f * (1 + 0.01 * rng.standard_normal(f.shape))).astype(np.float32)
    coords = [np.arange(n_phi, dtype=np.float64),
              np.arange(n_node, dtype=np.float64), vpa.astype(np.float64),
              vpe.astype(np.float64)]

    print(f"f0 snapshot {f.shape} = {f.nbytes / 1e6:.1f} MB "
          f"(nonuniform v-grids)")

    print("\n-- error-bounded compression (abs L-inf) --")
    for tol in (1e-2, 1e-3, 1e-4):
        t0 = time.perf_counter()
        buf = mt.compress(f, tol, coordinates=coords,
                          config=Config(lossless=lossless), device=dev)
        dt = time.perf_counter() - t0
        out = mt.decompress(buf, device=dev)
        err = np.abs(out - f).max()
        print(f"tol={tol:g}: {f.nbytes // 1024} KB -> {len(buf) // 1024} KB "
              f"({f.nbytes / len(buf):6.1f}x) err={err:.2e} "
              f"[{dt * 1e3:.0f} ms]")
        if not err <= tol:
            raise AssertionError(f"tol {tol}: error {err}")

    print("\n-- relative bound (XGC production mode) --")
    buf = mt.compress(f, 1e-3, mode="rel", coordinates=coords, device=dev)
    out = mt.decompress(buf, device=dev)
    rel = np.abs(out - f).max() / np.abs(f).max()
    print(f"rel 1e-3: ratio {f.nbytes / len(buf):.1f}x, rel err {rel:.2e}")
    if not rel <= 1e-3:
        raise AssertionError(f"relative error {rel} exceeds 1e-3")

    print("\n-- MDR: refactor once, retrieve progressively --")
    hier = Hierarchy(f.shape)
    ref = mdr.mdr_refactor(hier, f, lossless=mdr_lossless, device=dev)
    stored = sum(len(b) for streams in ref.streams for b in streams)
    print(f"refactored store: {stored // 1024} KB")
    for tol in (1e-1, 1e-2, 1e-3):
        out = mdr.mdr_reconstruct(hier, ref, tol, device=dev)
        got = np.abs(out - f).max()
        counts = mdr.mdr_request(ref.metadata, tol)
        read = sum(len(ref.streams[lev][0])
                   + sum(len(ref.streams[lev][1 + b]) for b in range(c))
                   for lev, c in enumerate(counts))
        print(f"tol={tol:g}: read {read // 1024} KB of {stored // 1024} KB "
              f"({100 * read / stored:.0f}%), err={got:.2e}")
        if not got <= tol:
            raise AssertionError(f"MDR at {tol}: error {got}")


if __name__ == "__main__":
    main()
