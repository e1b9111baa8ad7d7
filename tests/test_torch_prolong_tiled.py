"""K6 ``gpk_prolong_add`` as the tiled CUDA kernel computes it, on the CPU.

The kernel (``mgard_tpu_torch/csrc/stencil.cu``) runs only on the card.
``_tiled_prolong_add`` below is a plain PyTorch emulation of its staging,
kept in this file and not in the package: the loop over
``stencil_kernels.K6_TILE`` output tiles, each tile's parent window in
dims 0 and 1 taken from the coarse index tables (first and last parent
of positions ``[p0 - 1, p0 + T]``, never from parity), stage g2 over
that window's coarse box for every k of the tile, stage g0 at every i of
the tile, stage g1 plus ``detail``.  Every lerp is separate float32
operations in the kernel's order.

It is held bit for bit against ``gpk_prolong_add_plain`` and, on uniform
grids, against the Pallas K6 in interpret mode; on nonuniform grids the
interpreted Pallas kernel rounds its fused lerps otherwise (see
``tests/test_torch_stencil.py``) and is held to ``1e-6 * max|A|``.  So
an index, halo or trailing-node mistake of the tiling shows here before
the card runs it.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import stencil_kernels as jsk
from mgard_tpu.ops import transform as jt

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import stencil_kernels as sk

NONUNIFORM_BOUND = 1e-6
T0, T1, T2 = sk.K6_TILE
# the kernel's staging capacity: parent rows of a window in dims 0 and 1
ROWS0, ROWS1 = T0 // 2 + 1, T1 // 2 + 1


def _coords(shape, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for s in shape:
        c = np.sort(rng.uniform(size=s))
        c[0], c[-1] = 0.0, 1.0
        out.append(c)
    return out


def _window(c, p0, T, n):
    """Coarse index of the first parent of positions [p0 - 1, p0 + T]
    clipped to [0, n), and the number of parents there (the kernel's
    ``parent_window``)."""
    lo, hi = max(p0 - 1, 0), min(p0 + T, n - 1)
    first = c[lo] if c[lo] >= 0 else c[lo + 1]
    last = c[hi] if c[hi] >= 0 else c[hi - 1]
    return int(first), int(last - first + 1)


def _lerp(w, l, r):
    return (1 - w) * l + w * r


def _select(c, p, first):
    """For positions ``p``: parent mask, and the staged slot of the value
    itself (parents) or of its left and right parents (new positions)."""
    n = len(c)
    parent = c[p] >= 0
    left = np.where(parent, c[p], c[np.maximum(p - 1, 0)]) - first
    right = np.where(parent, c[p], c[np.minimum(p + 1, n - 1)]) - first
    return (torch.from_numpy(parent), torch.from_numpy(left),
            torch.from_numpy(right))


def _tiled_prolong_add(hier, C, detail, l):
    """K6 tile by tile, stage by stage, as csrc/stencil.cu runs it."""
    (_, w0, c0), (_, w1, c1), (_, w2, c2) = sk._mw_arrays(hier, l)
    w0, w1, w2 = (torch.from_numpy(w) for w in (w0, w1, w2))
    n0, n1, n2 = hier.shapes[l]
    assert n0 % T0 == 0 and n1 % T1 == 0 and n2 % T2 == 0
    out = torch.empty_like(detail)
    for i0 in range(0, n0, T0):
        ca, na = _window(c0, i0, T0, n0)
        assert na <= ROWS0
        ii = np.arange(i0, i0 + T0)
        pi, si, ri = _select(c0, ii, ca)
        wi = w0[ii][:, None, None]
        for j0 in range(0, n1, T1):
            cb, nb = _window(c1, j0, T1, n1)
            assert nb <= ROWS1
            jj = np.arange(j0, j0 + T1)
            pj, sj, rj = _select(c1, jj, cb)
            wj = w1[jj][None, :, None]
            box = C[ca:ca + na, cb:cb + nb]
            for k0 in range(0, n2, T2):
                kk = np.arange(k0, k0 + T2)
                pk, lk, rk = _select(c2, kk, 0)
                # stage 1: g2 at the window's parent rows, every k
                lo, hi = box[:, :, lk], box[:, :, rk]
                g2 = torch.where(pk, lo, _lerp(w2[kk], lo, hi))
                # stage 2: g0 at every i of the tile
                g0 = torch.where(pi[:, None, None], g2[si],
                                 _lerp(wi, g2[si], g2[ri]))
                # stage 3: g1 at every (i, j), plus detail
                g1 = torch.where(pj[None, :, None], g0[:, sj],
                                 _lerp(wj, g0[:, sj], g0[:, rj]))
                out[i0:i0 + T0, j0:j0 + T1, k0:k0 + T2] = \
                    g1 + detail[i0:i0 + T0, j0:j0 + T1, k0:k0 + T2]
    return out


CASES = [((16, 128, 128), True), ((16, 128, 128), False),
         ((8, 256, 128), True), ((8, 256, 128), False)]


@functools.lru_cache(maxsize=None)
def _pallas_case(shape, uniform):
    """A, the Pallas K5's detail of A, C = K1(A) and the Pallas K6's
    output on them, in interpret mode; numpy."""
    coords = None if uniform else _coords(shape)
    jh = JHierarchy(shape, coordinates=coords)
    A = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    det = np.asarray(jsk._run_fused_detail(jnp.asarray(A), jh, jh.L,
                                           interpret=True))
    C = np.asarray(jt._extract_old_all(jh, jnp.asarray(A), jh.L))
    out = np.asarray(jsk.gpk_prolong_add(jh, jnp.asarray(C),
                                         jnp.asarray(det), jh.L,
                                         interpret=True))
    return A, det, C, out


@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_tiled_staging_matches_plain_and_pallas(shape, uniform):
    A, det, C, ref = _pallas_case(shape, uniform)
    th = Hierarchy(shape, coordinates=None if uniform else _coords(shape))
    assert sk.gpk_structure_ok(th, th.L)
    Ct, dt = torch.from_numpy(C.copy()), torch.from_numpy(det.copy())
    got = _tiled_prolong_add(th, Ct, dt, th.L)
    plain = sk.gpk_prolong_add_plain(th, Ct, dt, th.L)
    assert got.numpy().tobytes() == plain.numpy().tobytes()
    if uniform:
        assert got.numpy().tobytes() == ref.tobytes()
    assert np.abs(got.numpy() - ref).max() \
        <= NONUNIFORM_BOUND * np.abs(A).max()


def test_tiled_staging_on_the_card_check_grid():
    """The nonuniform (64, 256, 256) grid that ``chip_smoke.py`` holds the
    kernel to: several tiles in every dim, a trailing parent in dims 0
    and 1, weights that are not 0.5 (so products round)."""
    shape = (64, 256, 256)
    th = Hierarchy(shape, coordinates=_coords(shape, seed=0))
    rng = np.random.default_rng(2)
    C = torch.from_numpy(rng.standard_normal(th.shapes[th.L - 1]
                                             ).astype(np.float32))
    det = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    got = _tiled_prolong_add(th, C, det, th.L)
    plain = sk.gpk_prolong_add_plain(th, C, det, th.L)
    assert got.numpy().tobytes() == plain.numpy().tobytes()


@pytest.mark.parametrize("shape", [(512, 512, 512), (16, 128, 256),
                                   (8, 256, 128), (64, 256, 256),
                                   (256, 128, 384), (24, 384, 640)],
                         ids=str)
def test_staging_capacity_at_every_gated_level(shape):
    """At every level the gate admits, every tile's parent window in
    dims 0 and 1 fits the kernel's staged rows, holds both parents of
    each new position of the tile, and dim 2's new positions have their
    parents inside the grid."""
    th = Hierarchy(shape)
    gated = [l for l in range(1, th.L + 1) if sk.gpk_structure_ok(th, l)]
    if shape in ((512, 512, 512), (16, 128, 256), (8, 256, 128)):
        assert gated
    for l in gated:
        tables = sk._mw_arrays(th, l)
        for d, T, cap in ((0, T0, ROWS0), (1, T1, ROWS1)):
            c = tables[d][2]
            n = len(c)
            assert n % T == 0
            for p0 in range(0, n, T):
                first, count = _window(c, p0, T, n)
                assert 1 <= count <= cap, (l, d, p0)
                p = np.arange(p0, p0 + T)
                new = p[c[p] < 0]
                for side in (new - 1, new + 1):
                    assert np.all(c[side] >= first)
                    assert np.all(c[side] < first + count)
        c2 = tables[2][2]
        assert len(c2) % T2 == 0 and c2[0] >= 0 and c2[-1] >= 0
