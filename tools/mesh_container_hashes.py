#!/usr/bin/env python3
"""Whether two checkouts of mgard_tpu_torch write the same MGTU containers
on small unstructured meshes.

    python3 tools/mesh_container_hashes.py OLD_CHECKOUT NEW_CHECKOUT

Runs, in one process for each checkout and on the CPU, 288 cases:
triangle grids (2, 2), (4, 3), (5, 2), (3, 2) and tet grids (2, 3, 2),
(2, 2, 2), each refined 1-3 times; six fields on the finest nodes
(smooth, noise, zero, 1e4 x smooth, smooth in float32, smooth with a
NaN); s in {0, 1, -1, 0.5}; tolerances 1e-1 and 1e-3.  Each case gives
the SHA-256 of its container and of its decode, or the type of the
exception it raised.  Prints how many cases raised, and exits non-zero
if any case differs between the checkouts (about a minute).
"""

import hashlib
import json
import subprocess
import sys

MESHES = [("tri", (2, 2), 3), ("tri", (4, 3), 2), ("tri", (5, 2), 2),
          ("tri", (3, 2), 1), ("tet", (2, 3, 2), 2), ("tet", (2, 2, 2), 1)]


def cases(checkout: str) -> dict:
    """{case: [container hash, decode hash] or [exception type]}."""
    sys.path.insert(0, checkout)
    import numpy as np
    import mgard_tpu_torch.unstructured as un

    out = {}
    for kind, n, L in MESHES:
        root = (un.structured_triangle_mesh(*n, device="cpu")
                if kind == "tri" else un.structured_tet_mesh(n, device="cpu"))
        h = un.UniformMeshHierarchy(root, L)
        x = h.meshes[-1].nodes.numpy()
        smooth = np.sin(3 * x[:, 0]) + x[:, 1] ** 2
        fields = {
            "smooth": smooth,
            "noise": np.random.default_rng(0).standard_normal(len(x)),
            "zero": np.zeros(len(x)), "big": 1e4 * smooth,
            "float32": smooth.astype(np.float32),
            "nan": np.where(np.arange(len(x)) == 1, np.nan, smooth)}
        for name, u in fields.items():
            for s in (0.0, 1.0, -1.0, 0.5):
                for tol in (1e-1, 1e-3):
                    key = f"{kind}{n} L={L} {name} s={s} tol={tol}"
                    try:
                        buf = un.compress(h, u, s, tol)
                        dec = un.decompress(h, buf)
                        out[key] = [hashlib.sha256(buf).hexdigest(),
                                    hashlib.sha256(dec.tobytes()).hexdigest()]
                    except Exception as e:  # the type is what is compared
                        out[key] = [type(e).__name__]
    return out


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    if sys.argv[1] == "--one":
        print(json.dumps(cases(sys.argv[2])))
        return 0
    old, new = (json.loads(subprocess.run(
        [sys.executable, __file__, "--one", path], check=True,
        capture_output=True, text=True).stdout) for path in sys.argv[1:3])
    differ = [k for k in old if old[k] != new.get(k)]
    raised = sum(len(v) == 1 for v in old.values())
    print(f"{len(old)} cases, {raised} raised in the first checkout; "
          f"{len(differ)} differ: {differ}")
    return 1 if differ or old.keys() != new.keys() else 0


if __name__ == "__main__":
    sys.exit(main())
