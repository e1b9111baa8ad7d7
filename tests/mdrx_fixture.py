"""A writer of synthetic `mdr-x` directories, shared by
``tests/test_torch_mdrx.py`` and ``chip_smoke.py``.

The reference's `mdr-x` tool writes these directories; neither package
has a writer.  This one follows the layout that
``mgard_tpu_torch/io/mdrx_compat.py`` documents (``header``,
``metadata``, ``component_<subdomain>_<level>_<bitplane>``) for one
subdomain, so that both packages' readers can be held against the
coefficients it wrote.  It imports the port and never JAX.
"""

from __future__ import annotations

import math
import pathlib
import struct

import numpy as np
import torch

from mgard_tpu_torch.api import resolve_device
from mgard_tpu_torch.io import mgard_compat as mc
from mgard_tpu_torch.ops import transform

BITPLANES = 32


def _pack_words(bits: torch.Tensor) -> torch.Tensor:
    """Inverse of the reader's ``_element_bits``: (ntb * 64,) bits ->
    (ntb, 2) int32 words, element ``j``'s bit at bit ``31 - j``."""
    shifts = torch.arange(31, -1, -1, dtype=torch.int64, device=bits.device)
    w = (bits.to(torch.int64).reshape(-1, 2, 32) << shifts).sum(2)
    return (w - ((w >> 31) << 32)).to(torch.int32)


def write_mdrx(directory, data: np.ndarray, device=None) -> np.ndarray:
    """Write ``data`` (float32 or float64, 2^k+1-compatible shape) as an
    MDR-X directory: one subdomain, its coefficients from the port's
    decomposition in the data's dtype (as the reference refactors in its
    dtype), BITPLANES planes a level, and each level's squared errors
    after 0..BITPLANES planes.  Returns the corner-layout float64
    coefficients that all planes represent (what a full-plane read
    recomposes)."""
    dev = resolve_device(device)
    data = np.asarray(data)
    if data.dtype not in (np.float32, np.float64):
        raise TypeError("MDR-X writer: float32/float64 only")
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    B = BITPLANES
    shape = tuple(data.shape)
    hier, l_target = mc._x_hierarchy(shape)
    v = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
    F = torch.zeros(shape, dtype=torch.float64, device=dev)
    for sl, blk in zip(mc._x_corner_slices(hier), transform.pyramid_to_blocks(
            hier, transform.decompose(hier, v))):
        F[sl] = blk.reshape(F[sl].shape).to(torch.float64)
    lin = mc._x_corner_to_linearized(F, l_target)
    counts = [int(np.prod(s)) for s in mc._x_level_shapes(shape, l_target)]
    sizes_l = [counts[0]] + [b - a for a, b in zip(counts, counts[1:])]

    bounds, sqerrs, sizes, kept, off = [], [], [], [], 0
    for level, n in enumerate(sizes_l):
        c = lin[off:off + n]
        off += n
        bound = float(c.abs().max())
        _, exp = math.frexp(bound)
        fp = torch.trunc(c.abs() * math.ldexp(1.0, B - exp)).to(torch.int64)
        unit = math.ldexp(1.0, exp - B)
        kept.append(torch.where(c < 0, -fp.to(torch.float64) * unit,
                                fp.to(torch.float64) * unit))
        ntb = -(-n // 64)
        fp_pad = torch.nn.functional.pad(fp, (0, ntb * 64 - n))
        sign = torch.nn.functional.pad((c < 0).to(torch.int64),
                                       (0, ntb * 64 - n))
        sq = []
        for b in range(B + 1):
            rest = (fp >> (B - b)) << (B - b)
            sq.append(float(((c.abs() - rest.to(torch.float64) * unit) ** 2
                             ).sum()))
            if b == B:
                break
            words = torch.zeros((ntb, 4), dtype=torch.int32, device=dev)
            words[:, 0:2] = _pack_words((fp_pad >> (B - 1 - b)) & 1)
            if b == 0:
                words[:, 2:4] = _pack_words(sign)
            (d / f"component_0_{level}_{b}").write_bytes(
                words.cpu().numpy().astype("<i4").tobytes())
        bounds.append(bound)
        sqerrs.append(sq)
        sizes.append([ntb * 16] * B)

    L = len(sizes_l)
    blob = struct.pack("<QQ", L, B) + np.asarray(bounds, "<f8").tobytes() \
        + np.asarray(sqerrs, "<f8").tobytes() \
        + np.asarray(sizes, "<u8").tobytes() \
        + np.asarray(sizes_l, "<u8").tobytes()
    (d / "metadata").write_bytes(struct.pack("<QQ", 1, len(blob)) + blob)
    header = {
        "mgard_version": {"major_": 1, "minor_": 0, "patch_": 0},
        "domain": {"topology": 0, "cartesian_grid_topology": {
            "dimension": data.ndim, "shape": list(shape)}, "geometry": 0},
        "dataset": {"type": mc.DATASET_FLOAT if data.dtype == np.float32
                    else mc.DATASET_DOUBLE, "dimension": 1},
        "error_control": {"mode": 0, "norm": mc.NORM_L_INFINITY},
        "domain_decomposition": {"method": 0,
                                 "decomposition_size": shape[0]},
        "function_decomposition": {"transform": 0,
                                   "hierarchy": mc.X_MULTIDIM_HIERARCHY},
        "device": {"backend": 1},
    }
    (d / "header").write_bytes(mc.write_container(header, b"",
                                                  little_endian=True))
    fine = mc._x_linearized_to_corner(torch.cat(kept), shape, l_target)
    return fine.cpu().numpy()
