"""mgard_tpu_torch's two-pass GPK form (``MGARD_TPU_GPK_FUSED=0``): K7
``run_b20``, K8 ``run_b1sub``, K9 ``run_dec_b20`` and K10
``run_dec_b1add`` against mgard_tpu's Pallas kernels and against the
port's one-pass pair, on the CPU.

* Each plain version against its Pallas kernel in interpret mode, on
  the same inputs: bit-identical on uniform grids, within
  ``NONUNIFORM_BOUND * max|A|`` on random-coordinate grids, for the
  reason ``tests/test_torch_stencil.py`` states (XLA fuses the
  interpreted lerp).  K9's Pallas output pads the coarse dim 1 to a
  multiple of 8; the port's does not, so only its first nc1 columns are
  compared.
* The two-pass compositions bit-identical to the one-pass plain
  versions, on both kinds of grid, at every level with parents at +-1.
* With GPK forced and ``_FUSED`` off on both sides, the decompositions
  agree within ``1e-5 * max|v|`` and containers cross-decode within the
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

import mgard_tpu
from mgard_tpu.config import Config as JConfig
from mgard_tpu.ops import stencil_kernels as jsk
from mgard_tpu.ops import transform as jt

import mgard_tpu_torch as mt
from mgard_tpu_torch.io.carry import pyramid_from_numpy
from mgard_tpu_torch.ops import stencil_kernels as sk
from mgard_tpu_torch.ops import transform as tt

from test_torch_stencil import (NONUNIFORM_BOUND, REL_BOUND, _force_gpk,
                                _hiers, _lerp_levels, _normal, _smooth)

ROOT = Path(__file__).resolve().parent.parent

SHAPES = [(8, 256, 128), (16, 128, 256), (32, 256, 128)]
CASES = [(s, u) for u in (True, False) for s in SHAPES]


@functools.lru_cache(maxsize=None)
def _case(shape, uniform):
    """The JAX two-pass kernels on one case, each on the inputs the next
    one takes: A, V0 = K7(A), detail = K8(V0, A), C = K1(A), W = K9(C)
    (padded) and out = K10(W, detail), all numpy."""
    jh, _ = _hiers(shape, uniform)
    L = jh.L
    A = _normal(shape, 6)
    v0 = jsk._run_b20(jnp.asarray(A), jh, L, interpret=True)
    det = jsk._run_b1sub(v0, jnp.asarray(A), jh, L, interpret=True)
    C = jt._extract_old_all(jh, jnp.asarray(A), L)
    W = jsk._run_dec_b20(jsk._embed2(C, jh, L), jh, L, interpret=True)
    out = jsk._run_dec_b1add(W, det, jh, L, interpret=True)
    return {k: np.asarray(x) for k, x in
            dict(A=A, V0=v0, detail=det, C=C, W=W, out=out).items()}


def _t(x):
    return torch.from_numpy(np.array(x))


def _check(got, want, uniform, scale):
    assert got.shape == want.shape
    if uniform:
        assert got.tobytes() == want.tobytes()
    assert np.abs(got - want).max() <= NONUNIFORM_BOUND * scale


# ---------------------------------------------------------------------------
# (a) each plain version against its Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_run_b20_plain_matches_pallas(shape, uniform):
    r = _case(shape, uniform)
    _, th = _hiers(shape, uniform)
    got = sk.run_b20(th, _t(r["A"]), th.L).numpy()
    assert np.array_equal(got, sk.run_b20_plain(th, _t(r["A"]), th.L)
                          .numpy())
    _check(got, r["V0"], uniform, np.abs(r["A"]).max())


@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_run_b1sub_plain_matches_pallas(shape, uniform):
    r = _case(shape, uniform)
    _, th = _hiers(shape, uniform)
    got = sk.run_b1sub(th, _t(r["V0"]), _t(r["A"]), th.L).numpy()
    assert np.array_equal(got, sk.run_b1sub_plain(
        th, _t(r["V0"]), _t(r["A"]), th.L).numpy())
    _check(got, r["detail"], uniform, np.abs(r["A"]).max())


@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_run_dec_b20_plain_matches_pallas(shape, uniform):
    r = _case(shape, uniform)
    _, th = _hiers(shape, uniform)
    got = sk.run_dec_b20(th, _t(r["C"]), th.L).numpy()
    assert np.array_equal(got, sk.run_dec_b20_plain(th, _t(r["C"]), th.L)
                          .numpy())
    nc1 = th.shapes[th.L - 1][1]
    assert got.shape == (shape[0], nc1, shape[2])
    assert r["W"].shape[1] == -(-nc1 // 8) * 8
    _check(got, r["W"][:, :nc1], uniform, np.abs(r["A"]).max())


@pytest.mark.parametrize("shape,uniform", CASES, ids=str)
def test_run_dec_b1add_plain_matches_pallas(shape, uniform):
    r = _case(shape, uniform)
    _, th = _hiers(shape, uniform)
    V0 = _t(r["W"][:, :th.shapes[th.L - 1][1]])
    got = sk.run_dec_b1add(th, V0, _t(r["detail"]), th.L).numpy()
    assert np.array_equal(got, sk.run_dec_b1add_plain(
        th, V0, _t(r["detail"]), th.L).numpy())
    _check(got, r["out"], uniform, np.abs(r["A"]).max())


# ---------------------------------------------------------------------------
# (b) two-pass against one-pass, in plain PyTorch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,uniform", CASES + [((20, 33, 18), False),
                                                   ((17, 17, 17), True)],
                         ids=str)
def test_two_pass_plain_bit_identical_to_fused(shape, uniform, monkeypatch):
    """K8(K7(A)) == K5(A) and K10(K9(C), detail) == K6(C, detail) bit for
    bit at every level with parents at +-1, also through the dispatchers
    with ``_FUSED`` off."""
    _, th = _hiers(shape, uniform)
    levels = _lerp_levels(th)
    assert levels
    for l in levels:
        A = _t(_normal(th.shapes[l], l))
        C = tt._extract_old_all(th, A, l)
        fused = sk.gpk_detail_plain(th, A, l)
        two = sk.run_b1sub_plain(th, sk.run_b20_plain(th, A, l), A, l)
        assert two.numpy().tobytes() == fused.numpy().tobytes(), l
        back = sk.gpk_prolong_add_plain(th, C, fused, l)
        two_back = sk.run_dec_b1add_plain(
            th, sk.run_dec_b20_plain(th, C, l), fused, l)
        assert two_back.numpy().tobytes() == back.numpy().tobytes(), l
        with monkeypatch.context() as m:
            m.setattr(sk, "_FUSED", False)
            assert torch.equal(sk.gpk_detail(th, A, l), fused)
            assert torch.equal(sk.gpk_prolong_add(th, C, fused, l), back)


# ---------------------------------------------------------------------------
# (c) the whole transform with GPK forced and the two-pass form on both sides
# ---------------------------------------------------------------------------

def _two_pass(monkeypatch):
    """Turn ``_FUSED`` off on both sides and count the calls of each
    package's two-pass kernels (K7-K10)."""
    calls = {}
    for mod, names in ((jsk, ("_run_b20", "_run_b1sub", "_run_dec_b20",
                              "_run_dec_b1add")),
                       (sk, ("run_b20", "run_b1sub", "run_dec_b20",
                             "run_dec_b1add"))):
        monkeypatch.setattr(mod, "_FUSED", False)
        for name in names:
            calls[name] = 0

            def call(*args, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] += 1
                return _fn(*args, **kw)
            monkeypatch.setattr(mod, name, call)
    return calls


@pytest.mark.parametrize("uniform", [True, False],
                         ids=["uniform", "coords"])
def test_forced_two_pass_decomposition_matches_jax(uniform, monkeypatch):
    shape = (16, 128, 256)
    calls = _force_gpk(monkeypatch)
    kernels = _two_pass(monkeypatch)
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
    assert set(kernels.values()) == {1}, kernels
    assert np.abs(rj - rt).max() <= REL_BOUND * scale
    assert np.abs(rt - v).max() <= REL_BOUND * scale


def test_forced_two_pass_containers_cross_decode(monkeypatch):
    """A port container made through K7/K8 decodes through mgard_tpu's
    two-pass kernels, and an mgard_tpu container made through them
    decodes through the port's K9/K10, both within the tolerance.  The
    JAX package's compressor cache is cleared around the test, so that
    its forced kernels are traced here and kept nowhere else."""
    shape, tol = (16, 128, 256), 1e-3
    v = _smooth(shape, seed=4)
    cfg = mt.Config(adapt_lossless=False)
    calls = _force_gpk(monkeypatch)
    kernels = _two_pass(monkeypatch)
    mgard_tpu.release_cache()
    try:
        b_jax = mgard_tpu.compress(v, tol,
                                   config=JConfig(adapt_lossless=False))
        b_port = mt.compress(v, tol, config=cfg, device="cpu")
        assert calls == {"gpk_detail": 1, "gpk_prolong_add": 0}
        out_port = mt.decompress(b_jax, device="cpu")
        out_jax = mgard_tpu.decompress(b_port)
    finally:
        mgard_tpu.release_cache()
    assert calls == {"gpk_detail": 1, "gpk_prolong_add": 1}
    assert set(kernels.values()) == {1}, kernels
    for out in (out_jax, out_port):
        assert out.shape == v.shape and out.dtype == np.float32
        assert np.abs(out - v).max() <= tol


# ---------------------------------------------------------------------------
# (d) the switch, (e) devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("value,fused", [(None, True), ("0", False),
                                         ("1", True)])
def test_switch_is_read_at_import(value, fused):
    env = {k: v for k, v in os.environ.items()
           if k != "MGARD_TPU_GPK_FUSED"}
    if value is not None:
        env["MGARD_TPU_GPK_FUSED"] = value
    out = subprocess.run(
        [sys.executable, "-c", "import mgard_tpu_torch.ops.stencil_kernels "
         "as sk; print(sk._FUSED)"], check=True, cwd=ROOT, env=env,
        capture_output=True, text=True).stdout.split()
    assert out == [str(fused)]


def test_devices_other_than_cpu_and_cuda_raise():
    _, th = _hiers((16, 128, 256), True)
    A = torch.zeros(th.shape, device="meta")
    C = torch.zeros(th.shapes[th.L - 1], device="meta")
    V0 = torch.zeros(sk._v0_shape(th, th.L), device="meta")
    calls = {"run_b20": lambda: sk.run_b20(th, A, th.L),
             "run_b1sub": lambda: sk.run_b1sub(th, A, A, th.L),
             "run_dec_b20": lambda: sk.run_dec_b20(th, C, th.L),
             "run_dec_b1add": lambda: sk.run_dec_b1add(th, V0, A, th.L)}
    for name, call in calls.items():
        with pytest.raises(ValueError, match=f"{name}: .* meta"):
            call()
        assert getattr(sk, name).launches == 0
