"""K9 ``run_dec_b20`` as the tiled CUDA kernel computes it, on the CPU.

The kernel (``mgard_tpu_torch/csrc/stencil.cu``) runs only on the card.
``_tiled_dec_b20`` below is a plain PyTorch emulation of its staging,
kept in this file and not in the package: the loop over
``stencil_kernels.K9_TILE`` tiles of V0 (8 fine i, 8 coarse j, 128 k),
each tile's parent window in dim 0 taken from the coarse index table
(first and last parent of positions ``[i0 - 1, i0 + 8]``, never from
parity), stage g2 over that window's coarse rows for each coarse j of
the tile (masked at the ragged edge of the odd nc1), stage g0 at every
i of the tile.  Every lerp is separate float32 operations in the
kernel's order.

It is held bit for bit against ``run_dec_b20_plain``, and against the
Pallas ``_run_dec_b20`` in interpret mode: bit for bit on uniform grids,
within ``1e-6 * max|A|`` on nonuniform ones (the interpreted Pallas
kernel rounds its fused lerps otherwise, see
``tests/test_torch_stencil.py``).  K10 of the emulated V0 is K6's plain
version bit for bit.  So an index, halo or edge mistake of the tiling
shows here before the card runs it.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgard_tpu.ops import stencil_kernels as jsk
from mgard_tpu.ops import transform as jt

from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.ops import stencil_kernels as sk

from test_torch_stencil import NONUNIFORM_BOUND, _coords, _hiers, _normal

T0, TJ, T2 = sk.K9_TILE
ROWS0 = T0 // 2 + 1


def _window(c, p0, T, n):
    """The kernel's ``parent_window``: coarse index of the first parent
    of positions [p0 - 1, p0 + T] clipped to [0, n), and their count."""
    lo, hi = max(p0 - 1, 0), min(p0 + T, n - 1)
    first = c[lo] if c[lo] >= 0 else c[lo + 1]
    last = c[hi] if c[hi] >= 0 else c[hi - 1]
    return int(first), int(last - first + 1)


def _lerp(w, l, r):
    return (1 - w) * l + w * r


def _select(c, p, first):
    n = len(c)
    parent = c[p] >= 0
    left = np.where(parent, c[p], c[np.maximum(p - 1, 0)]) - first
    right = np.where(parent, c[p], c[np.minimum(p + 1, n - 1)]) - first
    return (torch.from_numpy(parent), torch.from_numpy(left),
            torch.from_numpy(right))


def _tiled_dec_b20(hier, C, l):
    """K9 tile by tile, stage by stage, as csrc/stencil.cu runs it."""
    (_, w0, c0), _, (_, w2, c2) = sk._mw_arrays(hier, l)
    w0, w2 = torch.from_numpy(w0), torch.from_numpy(w2)
    n0, nc1, n2 = sk._v0_shape(hier, l)
    assert n0 % T0 == 0 and n2 % T2 == 0
    out = torch.full((n0, nc1, n2), float("nan"))
    for i0 in range(0, n0, T0):
        ca, na = _window(c0, i0, T0, n0)
        assert na <= ROWS0
        ii = np.arange(i0, i0 + T0)
        pi, si, ri = _select(c0, ii, ca)
        wi = w0[ii][:, None, None]
        for j0 in range(0, nc1, TJ):
            nj = min(TJ, nc1 - j0)          # the ragged edge
            box = C[ca:ca + na, j0:j0 + nj]
            for k0 in range(0, n2, T2):
                kk = np.arange(k0, k0 + T2)
                pk, lk, rk = _select(c2, kk, 0)
                # stage 1: g2 at the window's parent rows, every k
                lo, hi = box[:, :, lk], box[:, :, rk]
                g2 = torch.where(pk, lo, _lerp(w2[kk], lo, hi))
                # stage 2: g0 at every i of the tile
                out[i0:i0 + T0, j0:j0 + nj, k0:k0 + T2] = torch.where(
                    pi[:, None, None], g2[si], _lerp(wi, g2[si], g2[ri]))
    return out


SHAPES = [(8, 256, 128), (16, 128, 256), (32, 256, 128)]
CASES = [(s, u) for u in (True, False) for s in SHAPES]


@functools.lru_cache(maxsize=None)
def _pallas_case(shape, uniform):
    """A, C = K1(A) and the Pallas K9's V0 (padded in dim 1) on C, in
    interpret mode; numpy."""
    jh, _ = _hiers(shape, uniform)
    A = _normal(shape, 6)
    C = jt._extract_old_all(jh, jnp.asarray(A), jh.L)
    W = jsk._run_dec_b20(jsk._embed2(C, jh, jh.L), jh, jh.L, interpret=True)
    return A, np.asarray(C), np.asarray(W)


@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_tiled_staging_matches_plain_and_pallas(shape, uniform):
    A, C, W = _pallas_case(shape, uniform)
    _, th = _hiers(shape, uniform)
    assert sk.gpk_structure_ok(th, th.L)
    Ct = torch.from_numpy(C.copy())
    got = _tiled_dec_b20(th, Ct, th.L)
    plain = sk.run_dec_b20_plain(th, Ct, th.L)
    assert got.numpy().tobytes() == plain.numpy().tobytes()
    ref = W[:, :got.shape[1]]
    if uniform:
        assert got.numpy().tobytes() == ref.tobytes()
    assert np.abs(got.numpy() - ref).max() \
        <= NONUNIFORM_BOUND * np.abs(A).max()


def test_k10_of_the_tiles_is_k6_on_the_card_check_grid():
    """The nonuniform (64, 256, 256) grid that ``chip_smoke.py`` holds the
    kernels to: K10 of the tiled V0 is K6's plain version bit for bit;
    nc1 = 129 leaves a one-row tile at the edge."""
    shape = (64, 256, 256)
    th = Hierarchy(shape, coordinates=_coords(shape, seed=0))
    rng = np.random.default_rng(2)
    C = torch.from_numpy(rng.standard_normal(th.shapes[th.L - 1]
                                             ).astype(np.float32))
    det = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    V0 = _tiled_dec_b20(th, C, th.L)
    assert V0.shape[1] % TJ == 1
    assert V0.numpy().tobytes() == sk.run_dec_b20_plain(
        th, C, th.L).numpy().tobytes()
    got = sk.run_dec_b1add_plain(th, V0, det, th.L)
    want = sk.gpk_prolong_add_plain(th, C, det, th.L)
    assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("shape", [(512, 512, 512), (16, 128, 256),
                                   (8, 256, 128), (64, 256, 256),
                                   (256, 128, 384), (24, 384, 640)],
                         ids=str)
def test_staging_capacity_and_ragged_edge(shape):
    """At every level the gate admits: every tile's parent window in dim
    0 fits the kernel's staged rows and holds both parents of each new i
    of the tile; dim 2's new positions have their parents in the grid;
    the grid in j covers nc1 with a last tile of nc1 mod 8 rows (or 8)
    and in the card's limits."""
    th = Hierarchy(shape)
    gated = [l for l in range(1, th.L + 1) if sk.gpk_structure_ok(th, l)]
    if shape in ((512, 512, 512), (16, 128, 256), (8, 256, 128)):
        assert gated
    for l in gated:
        tables = sk._mw_arrays(th, l)
        c = tables[0][2]
        n0, nc1, n2 = sk._v0_shape(th, l)
        assert n0 % T0 == 0 and n2 % T2 == 0 and nc1 % 2 == 1
        for p0 in range(0, n0, T0):
            first, count = _window(c, p0, T0, n0)
            assert 1 <= count <= ROWS0, (l, p0)
            p = np.arange(p0, p0 + T0)
            new = p[c[p] < 0]
            for side in (new - 1, new + 1):
                assert np.all(c[side] >= first)
                assert np.all(c[side] < first + count)
        c2 = tables[2][2]
        assert c2[0] >= 0 and c2[-1] >= 0
        tiles = -(-nc1 // TJ)
        assert tiles <= 65535 and n0 // T0 <= 65535
        assert nc1 - (tiles - 1) * TJ in range(1, TJ + 1)
