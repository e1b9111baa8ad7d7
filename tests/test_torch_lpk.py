"""mgard_tpu_torch's LPK correction (``MGARD_TPU_LPK=1``): K13
``rm_dim0`` and the ``[Minv0_pad, K1, K2]`` chain against mgard_tpu's, on
the CPU.

* The host tables (the tap table and the finishing matrices) equal the
  JAX package's bit for bit.
* K13's plain version against the Pallas ``rm_dim0`` in interpret mode
  over the first nc0 rows, within ``KERNEL_BOUND = 1e-6 * max|ref|``:
  XLA compiles the interpreted kernel and may contract its products and
  sums into FMAs, which round otherwise than the plain version's
  separate ops (observed at most 1e-7 * max|ref|).  The pad rows are
  exactly 0 in the port.
* The LPK correction against the matmul correction, and with LPK forced
  on both sides the decompositions, within ``REL_BOUND = 1e-5 * max``
  (the bound of ``tests/test_lpk_kernels.py`` and
  ``tests/test_torch_transform.py``); containers cross-decode within the
  tolerance in both directions.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import mgard_tpu
from mgard_tpu.config import Config as JConfig
from mgard_tpu.ops import lpk_kernels as jlk
from mgard_tpu.ops import transform as jt

import mgard_tpu_torch as mt
from mgard_tpu_torch.io.carry import pyramid_from_numpy
from mgard_tpu_torch.ops import bp_kernels as bk
from mgard_tpu_torch.ops import lpk_kernels as lk
from mgard_tpu_torch.ops import transform as tt

from test_torch_stencil import _hiers, _normal, _smooth

ROOT = Path(__file__).resolve().parent.parent

KERNEL_BOUND = 1e-6
REL_BOUND = 1e-5

SHAPES = [(32, 64, 128), (16, 128, 128)]
CASES = [(s, True) for s in SHAPES] + [((32, 64, 128), False)]


@functools.lru_cache(maxsize=None)
def _jax_rm(shape, uniform):
    """The Pallas K13 in interpret mode on a seeded normal field, numpy."""
    jh, _ = _hiers(shape, uniform)
    B = _normal(shape, 5)
    return B, np.asarray(jlk.rm_dim0(jh, jnp.asarray(B), jh.L,
                                     interpret=True))


# ---------------------------------------------------------------------------
# (a) host tables, (b) K13's plain version, (c) the LPK correction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_tables_match_jax(shape, uniform):
    jh, th = _hiers(shape, uniform)
    L = th.L
    assert lk.rm0_structure_ok(th, L)
    tab = lk.rm0_tables(th, L)
    assert tab.dtype == np.float32 and tab.shape == (-(-(shape[0] // 2 + 1)
                                                     // 8) * 8, 128)
    assert tab.tobytes() == jlk.rm0_tables(jh, L).tobytes()
    got = lk.correction_matrices_fast(th, L)
    want = jlk.correction_matrices_fast(jh, L)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64
        assert np.array_equal(a, b)


@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_rm_dim0_plain_matches_pallas(shape, uniform):
    B, ref = _jax_rm(shape, uniform)
    _, th = _hiers(shape, uniform)
    L = th.L
    nc0 = th.dims[0][L].front_nc + 1
    got = lk.rm_dim0(th, torch.from_numpy(B), L).numpy()
    assert got.shape == ref.shape == (-(-nc0 // 8) * 8,) + shape[1:]
    assert got.tobytes() == lk.rm_dim0_plain(
        th, torch.from_numpy(B), L).numpy().tobytes()
    scale = np.abs(ref[:nc0]).max()
    assert np.abs(got[:nc0] - ref[:nc0]).max() <= KERNEL_BOUND * scale
    assert not got[nc0:].any()


@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_lpk_correction_matches_matmul(shape, uniform):
    _, th = _hiers(shape, uniform)
    L = th.L
    B = torch.from_numpy(_normal(shape, 1))
    dims = tt._level_dims(th, L)
    ref = tt._correction(th, B, L)
    Y = lk.rm_dim0(th, B, L)
    mats = tt._device_mats(th, "_corr_fast_mats", L,
                           lk.correction_matrices_fast(th, L), Y)
    got = tt._apply_matrix_chain(Y, mats, dims)
    assert got.shape == ref.shape == th.shapes[L - 1]
    assert float((got - ref).abs().max()) <= REL_BOUND * float(
        ref.abs().max())


def test_gate():
    """The structure test admits the finest level of 2^k shapes with the
    tileable sizes only, and the gate admits float32 CUDA tensors only."""
    _, th = _hiers((32, 64, 128), True)
    assert lk.rm0_structure_ok(th, th.L)
    assert not any(lk.rm0_structure_ok(th, l) for l in range(1, th.L))
    for shape in [(24, 64, 128), (32, 32, 128), (32, 64, 64), (33, 65, 129)]:
        _, h = _hiers(shape, True)
        assert not lk.rm0_structure_ok(h, h.L), shape
    A = torch.zeros(th.shape)
    assert not lk.rm0_supported(th, th.L, A)
    assert not lk.rm0_supported(th, th.L, A.to(device="meta"))


# ---------------------------------------------------------------------------
# (d) the whole transform with LPK forced on both sides
# ---------------------------------------------------------------------------

def _force_lpk(monkeypatch):
    """Turn ``_LPK`` on in both packages and engage K13 off the card: the
    JAX package's gate without its backend test (its kernel then runs in
    interpret mode under ``pltpu.force_tpu_interpret_mode``); the port's
    gate without its CUDA test (its wrapper then takes the plain
    version).  Returns each package's K13 call count."""
    orig = jlk.rm0_supported

    def jax_gate(hier, l):
        with monkeypatch.context() as m:
            m.setattr(jax, "default_backend", lambda: "tpu")
            return orig(hier, l)

    calls = {"jax": 0, "port": 0}

    def counted(fn, key):
        def call(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(jt, "_LPK", True)
    monkeypatch.setattr(tt, "_LPK", True)
    monkeypatch.setattr(jlk, "rm0_supported", jax_gate)
    monkeypatch.setattr(jlk, "rm_dim0", counted(jlk.rm_dim0, "jax"))
    monkeypatch.setattr(lk, "rm0_supported",
                        lambda hier, l, B: B.dtype == torch.float32
                        and lk.rm0_structure_ok(hier, l))
    monkeypatch.setattr(lk, "rm_dim0", counted(lk.rm_dim0, "port"))
    return calls


@pytest.mark.parametrize("uniform", [True, False],
                         ids=["uniform", "coords"])
def test_forced_lpk_decomposition_matches_jax(uniform, monkeypatch):
    shape = (32, 64, 128)
    calls = _force_lpk(monkeypatch)
    jh, th = _hiers(shape, uniform)
    v = _smooth(shape)
    scale = float(np.abs(v).max())

    with pltpu.force_tpu_interpret_mode():
        jp = [np.asarray(p) for p in
              jax.jit(lambda a: jt.decompose(jh, a))(jnp.asarray(v))]
    tp = [p.numpy() for p in tt.decompose(th, torch.from_numpy(v))]
    assert calls == {"jax": 1, "port": 1}
    assert [p.shape for p in tp] == [p.shape for p in jp]
    err = max(float(np.abs(a - b).max()) for a, b in zip(jp, tp))
    assert err <= REL_BOUND * scale, err

    with pltpu.force_tpu_interpret_mode():
        rj = np.asarray(jax.jit(lambda *p: jt.recompose(jh, list(p)))(*jp))
    rt = tt.recompose(th, pyramid_from_numpy(th, jp, "cpu")).numpy()
    assert calls == {"jax": 2, "port": 2}
    assert np.abs(rj - rt).max() <= REL_BOUND * scale
    assert np.abs(rt - v).max() <= REL_BOUND * scale


def test_forced_lpk_containers_cross_decode(monkeypatch):
    """A port container made through K13 decodes through mgard_tpu's LPK
    correction, and an mgard_tpu container made through its K13 decodes
    through the port's, both within the tolerance.  The JAX package's
    compressor cache is cleared around the test, so that its forced
    kernel is traced here and kept nowhere else."""
    shape, tol = (32, 64, 128), 1e-3
    v = _smooth(shape, seed=4)
    calls = _force_lpk(monkeypatch)
    mgard_tpu.release_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            b_jax = mgard_tpu.compress(v, tol,
                                       config=JConfig(adapt_lossless=False))
        b_port = mt.compress(v, tol, config=mt.Config(adapt_lossless=False),
                             device="cpu")
        assert calls == {"jax": 1, "port": 1}
        out_port = mt.decompress(b_jax, device="cpu")
        with pltpu.force_tpu_interpret_mode():
            out_jax = mgard_tpu.decompress(b_port)
    finally:
        mgard_tpu.release_cache()
    assert calls == {"jax": 2, "port": 2}
    for out in (out_jax, out_port):
        assert out.shape == v.shape and out.dtype == np.float32
        assert np.abs(out - v).max() <= tol


def test_lpk_skips_float64_and_other_levels(monkeypatch):
    """Under ``_LPK`` the port's transform runs K13 at the admitted finest
    level of float32 data only, and float64 data keeps the matmul chain,
    as in the JAX package."""
    calls = _force_lpk(monkeypatch)
    _, th = _hiers((32, 64, 128), True)
    v = _smooth(th.shape)
    tt.decompose(th, torch.from_numpy(v))
    assert calls["port"] == 1
    tt.decompose(th, torch.from_numpy(v.astype(np.float64)))
    assert calls["port"] == 1


# ---------------------------------------------------------------------------
# (e) the switch, (f) devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,lpk", [(None, False), ("0", False),
                                       ("1", True)])
def test_switch_is_read_at_import(value, lpk):
    env = {k: v for k, v in os.environ.items() if k != "MGARD_TPU_LPK"}
    if value is not None:
        env["MGARD_TPU_LPK"] = value
    out = subprocess.run(
        [sys.executable, "-c", "import mgard_tpu_torch.ops.transform "
         "as tt; print(tt._LPK)"], check=True, cwd=ROOT, env=env,
        capture_output=True, text=True).stdout.split()
    assert out == [str(lpk)]


def test_devices_other_than_cpu_and_cuda_raise():
    _, th = _hiers((32, 64, 128), True)
    B = torch.zeros(th.shape, device="meta")
    with pytest.raises(ValueError, match="rm_dim0: .* meta"):
        lk.rm_dim0(th, B, th.L)
    seg = torch.zeros(4 * 32 * 128, device="meta")
    with pytest.raises(ValueError, match="bp_quant_zigzag: .* meta"):
        bk.bp_quant_zigzag(seg, 4, 128, 1.0)
    i32 = functools.partial(torch.zeros, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="bp_condense_into: .* meta"):
        bk.bp_condense_into(i32(4, 32, 128), i32(4), i32(4), i32(4 * 33 * 128))
    assert lk.rm_dim0.launches == bk.bp_quant_zigzag.launches \
        == bk.bp_condense_into.launches == 0
