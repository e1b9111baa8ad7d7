"""mgard_tpu_torch's GPK stencil pair (K5 ``gpk_detail``, K6
``gpk_prolong_add``) against mgard_tpu's kernels and math spec, on the
CPU.

* On uniform grids the plain versions are bit-identical to the JAX
  package's Pallas kernels run in interpret mode: every weight is 0.5,
  so each product is exact and the lerps round alike.
* On nonuniform grids they are not: XLA compiles the interpreted kernel
  and fuses ``(1-w)*l + w*r``, which then rounds otherwise than the
  same ops run one by one (the JAX spec's lerps run eagerly in the
  kernels' order are bit-identical to the port's on every grid tested
  here).  About 15% of the values
  differ, by at most 1.1e-7 * max|A| (observed), held to
  ``NONUNIFORM_BOUND = 1e-6 * max|A|``.
* With GPK forced on both sides, the decompositions agree within the
  ``1e-5 * max|v|`` of ``tests/test_torch_transform.py``, and containers
  cross-decode within the tolerance in both directions.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mgard_tpu
from mgard_tpu.config import Config as JConfig
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import stencil as jst
from mgard_tpu.ops import stencil_kernels as jsk
from mgard_tpu.ops import transform as jt

import mgard_tpu_torch as mt
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.io.carry import pyramid_from_numpy
from mgard_tpu_torch.ops import stencil_kernels as sk
from mgard_tpu_torch.ops import transform as tt

REL_BOUND = 1e-5
NONUNIFORM_BOUND = 1e-6
DIM_ORDER_BOUND = 1e-6


def _coords(shape, seed=3):
    """Sorted random coordinates on [0, 1] with fixed end points."""
    rng = np.random.default_rng(seed)
    out = []
    for s in shape:
        c = np.sort(rng.uniform(size=s))
        c[0], c[-1] = 0.0, 1.0
        out.append(c)
    return out


def _hiers(shape, uniform):
    coords = None if uniform else _coords(shape)
    return (JHierarchy(shape, coordinates=coords),
            Hierarchy(shape, coordinates=coords))


def _normal(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _smooth(shape, seed=0):
    x = [np.linspace(0.0, 1.0, s, dtype=np.float32) for s in shape]
    f = np.zeros(shape, dtype=np.float32)
    for k in (1, 3, 7):
        term = np.ones(shape, dtype=np.float32)
        for d, xx in enumerate(x):
            shp = [1] * len(shape)
            shp[d] = len(xx)
            term = term * np.cos(np.pi * k * xx + 0.1 * k * (d + 1)
                                 ).reshape(shp)
        f = f + term / k
    rng = np.random.default_rng(seed)
    return (f + 0.001 * rng.standard_normal(shape).astype(np.float32)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# The spec (mgard_tpu/ops/stencil.py)
# ---------------------------------------------------------------------------

def _lerp_levels(hier):
    """The levels whose every dim has its parents at +-1."""
    return [l for l in range(1, hier.L + 1)
            if all(sk._dim_ok_encode(hier.dims[d][l]) for d in range(3))]


@pytest.mark.parametrize("shape,uniform", [((17, 17, 17), True),
                                           ((16, 32, 24), True),
                                           ((20, 33, 18), False),
                                           ((12, 40, 9), False),
                                           ((16, 128, 256), False)],
                         ids=str)
def test_stencil_spec_matches_jax(shape, uniform):
    """K5's plain version against the JAX spec run op by op (eager) at
    every level with parents at +-1: bit-identical with the spec's lerps
    applied in the kernels' order (dim 2, 0, 1), and within
    ``DIM_ORDER_BOUND`` of ``detail_stencil``, whose order is dim 0, 1, 2
    (observed at most 1.1e-7 * max|A|)."""
    jh, th = _hiers(shape, uniform)
    levels = _lerp_levels(th)
    assert levels
    for l in levels:
        A = _normal(jh.shapes[l], l)
        got = sk.gpk_detail_plain(th, torch.from_numpy(A), l).numpy()
        V, vecs = jnp.asarray(A), jst._interp_vectors(jh, l)
        for d in (2, 0, 1):
            V = jst._interp_dim(V, vecs[d][0], vecs[d][1], d)
        assert got.tobytes() == np.asarray(jnp.asarray(A) - V).tobytes()
        ref = np.asarray(jst.detail_stencil(jh, jnp.asarray(A), l))
        assert np.abs(got - ref).max() <= DIM_ORDER_BOUND * np.abs(A).max()
        assert np.all(got[_parents(th, l)] == 0.0)


# ---------------------------------------------------------------------------
# K5 / K6 plain versions against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

KERNEL_CASES = [((8, 256, 128), True), ((16, 128, 256), True),
                ((8, 256, 128), False)]


@functools.lru_cache(maxsize=None)
def _pallas_case(shape, uniform):
    """The JAX kernels' outputs on one case: A, K5(A), C = K1(A) and
    K6(C, K5(A)), all numpy."""
    jh, _ = _hiers(shape, uniform)
    A = _normal(shape, 1)
    det = np.asarray(jsk._run_fused_detail(jnp.asarray(A), jh, jh.L,
                                           interpret=True))
    C = np.asarray(jt._extract_old_all(jh, jnp.asarray(A), jh.L))
    out = np.asarray(jsk.gpk_prolong_add(jh, jnp.asarray(C),
                                         jnp.asarray(det), jh.L,
                                         interpret=True))
    return A, det, C, out


def _parents(hier, l):
    p = [np.asarray(hier.dims[d][l].coarse_pos) for d in range(3)]
    return np.ix_(*p)


@pytest.mark.parametrize("shape,uniform", KERNEL_CASES, ids=str)
def test_gpk_detail_plain_matches_pallas(shape, uniform):
    A, ref, _, _ = _pallas_case(shape, uniform)
    _, th = _hiers(shape, uniform)
    got = sk.gpk_detail(th, torch.from_numpy(A.copy()), th.L).numpy()
    assert np.array_equal(got, sk.gpk_detail_plain(
        th, torch.from_numpy(A.copy()), th.L).numpy())
    if uniform:
        assert got.tobytes() == ref.tobytes()
    assert np.abs(got - ref).max() <= NONUNIFORM_BOUND * np.abs(A).max()
    assert np.all(got[_parents(th, th.L)] == 0.0)


@pytest.mark.parametrize("shape,uniform", KERNEL_CASES, ids=str)
def test_gpk_prolong_add_plain_matches_pallas(shape, uniform):
    A, det, C, ref = _pallas_case(shape, uniform)
    _, th = _hiers(shape, uniform)
    got = sk.gpk_prolong_add(th, torch.from_numpy(C.copy()),
                             torch.from_numpy(det.copy()), th.L).numpy()
    if uniform:
        assert got.tobytes() == ref.tobytes()
    scale = float(np.abs(A).max())
    assert np.abs(got - ref).max() <= NONUNIFORM_BOUND * scale
    # the port's own pair inverts itself
    Ct, At = torch.from_numpy(C.copy()), torch.from_numpy(A.copy())
    back = sk.gpk_prolong_add(th, Ct, sk.gpk_detail(th, At, th.L), th.L)
    assert float((back - At).abs().max()) <= REL_BOUND * scale


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------

GATE_SHAPES = [(512, 512, 512), (16, 128, 256), (8, 256, 128),
               (9, 257, 129), (257, 257, 257), (1, 256, 128),
               (16, 128, 1), (16, 96, 256), (16, 128, 200), (24, 128, 256),
               (20, 33, 18), (128, 256), (100, 384, 640)]


@pytest.mark.parametrize("shape", GATE_SHAPES, ids=str)
def test_gate_matches_jax(shape, monkeypatch):
    """gpk_structure_ok is the JAX package's decode gate on a TPU, at
    every level; a CPU tensor never passes gpk_supported."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    jh, th = JHierarchy(shape), Hierarchy(shape)
    for l in range(1, jh.L + 1):
        want = jsk.gpk_supported(jh, l, decode=True)
        assert sk.gpk_structure_ok(th, l) == want, l
        if want:
            assert not sk.gpk_supported(th, l, torch.zeros(1))


def test_gate_at_512_cube_is_the_finest_level_only():
    th = Hierarchy((512, 512, 512))
    assert [l for l in range(1, th.L + 1) if sk.gpk_structure_ok(th, l)] \
        == [th.L]


def test_tables_reject_levels_without_parents_at_pm1():
    th = Hierarchy((20, 33, 18), placement="reference")
    bad = [l for l in range(1, th.L + 1) if l not in _lerp_levels(th)]
    assert bad
    with pytest.raises(ValueError, match="parents at \\+-1"):
        sk.gpk_detail(th, torch.zeros(th.shapes[bad[0]]), bad[0])


def test_devices_other_than_cpu_and_cuda_raise():
    th = Hierarchy((16, 128, 256))
    A = torch.zeros(th.shape, device="meta")
    C = torch.zeros(th.shapes[th.L - 1], device="meta")
    with pytest.raises(ValueError, match="meta"):
        sk.gpk_detail(th, A, th.L)
    with pytest.raises(ValueError, match="meta"):
        sk.gpk_prolong_add(th, C, A, th.L)
    assert sk.gpk_detail.launches == 0 and sk.gpk_prolong_add.launches == 0


# ---------------------------------------------------------------------------
# The whole transform with GPK forced on both sides
# ---------------------------------------------------------------------------

def _force_gpk(monkeypatch):
    """Engage GPK off the card: the JAX package's gate without its backend
    test and its kernels in interpret mode; the port's gate without its
    CUDA test (its wrappers then take the plain versions).  Returns the
    port's per-kernel call counts."""
    orig = jsk.gpk_supported

    def jax_gate(hier, l, decode):
        with monkeypatch.context() as m:
            m.setattr(jax, "default_backend", lambda: "tpu")
            return orig(hier, l, decode)

    monkeypatch.setattr(jsk, "gpk_supported", jax_gate)
    monkeypatch.setattr(jsk, "gpk_detail",
                        functools.partial(jsk.gpk_detail, interpret=True))
    monkeypatch.setattr(jsk, "gpk_prolong_add",
                        functools.partial(jsk.gpk_prolong_add,
                                          interpret=True))
    calls = {"gpk_detail": 0, "gpk_prolong_add": 0}

    def counted(fn):
        def call(*args):
            calls[fn.__name__] += 1
            return fn(*args)
        return call

    monkeypatch.setattr(sk, "gpk_supported",
                        lambda hier, l, A: A.dtype == torch.float32
                        and sk.gpk_structure_ok(hier, l))
    monkeypatch.setattr(sk, "gpk_detail", counted(sk.gpk_detail))
    monkeypatch.setattr(sk, "gpk_prolong_add", counted(sk.gpk_prolong_add))
    return calls


@pytest.mark.parametrize("uniform", [True, False],
                         ids=["uniform", "coords"])
def test_forced_gpk_decomposition_matches_jax(uniform, monkeypatch):
    shape = (16, 128, 256)
    calls = _force_gpk(monkeypatch)
    jh, th = _hiers(shape, uniform)
    v = _smooth(shape)
    scale = float(np.abs(v).max())

    jp = [np.asarray(p) for p in
          jax.jit(lambda a: jt.decompose(jh, a))(jnp.asarray(v))]
    tp = [p.numpy() for p in tt.decompose(th, torch.from_numpy(v))]
    assert calls == {"gpk_detail": 1, "gpk_prolong_add": 0}
    assert [p.shape for p in tp] == [p.shape for p in jp]
    err = max(float(np.abs(a - b).max()) for a, b in zip(jp, tp))
    assert err <= REL_BOUND * scale, err

    rj = np.asarray(jax.jit(lambda *p: jt.recompose(jh, list(p)))(*jp))
    rt = tt.recompose(th, pyramid_from_numpy(th, jp, "cpu")).numpy()
    assert calls == {"gpk_detail": 1, "gpk_prolong_add": 1}
    assert np.abs(rj - rt).max() <= REL_BOUND * scale
    assert np.abs(rt - v).max() <= REL_BOUND * scale


def test_forced_gpk_containers_cross_decode(monkeypatch):
    """A port container made through K5 decodes with mgard_tpu (its
    matmul path on the CPU), and an mgard_tpu container decodes through
    the port's K6, both within the tolerance."""
    shape, tol = (16, 128, 256), 1e-3
    v = _smooth(shape, seed=2)
    cfg = mt.Config(adapt_lossless=False)
    b_jax = mgard_tpu.compress(v, tol, config=JConfig(adapt_lossless=False))
    calls = _force_gpk(monkeypatch)
    b_port = mt.compress(v, tol, config=cfg, device="cpu")
    assert calls == {"gpk_detail": 1, "gpk_prolong_add": 0}
    out_port = mt.decompress(b_jax, device="cpu")
    assert calls == {"gpk_detail": 1, "gpk_prolong_add": 1}
    monkeypatch.undo()
    out_jax = mgard_tpu.decompress(b_port)
    for out in (out_jax, out_port):
        assert out.shape == v.shape and out.dtype == np.float32
        assert np.abs(out - v).max() <= tol
