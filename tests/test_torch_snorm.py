"""mgard_tpu_torch's s-norm error control (finite s) against mgard_tpu,
on the CPU.

* The finite-s quantizer: ``scale_pyramid``/``dequantize_pyramid`` give
  the JAX functions' bits on the same pyramid (uniform and nonuniform,
  float32 and float64, with a flat dim), and the rounded ints are the
  same.
* Round trips through the port for s in {0, 1, -1} on each codec that
  carries finite s: the segmented stream (``adapt_lossless=False``; its
  decode goes through K11 once per level and never K4), the flat PYRAMID
  stream, the per-group codec and the wide float64 codec, each within
  ``||v - out||_s <= tol``.
* The compressor's REL norm by s.

The cross-decodes with mgard_tpu are in ``test_torch_snorm_e2e.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mgard_tpu.config import Config as JConfig, Layout as JLayout
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import quantize as jq

import mgard_tpu_torch as mt
from mgard_tpu_torch.hierarchy import Hierarchy as THierarchy
from mgard_tpu_torch.io import format as tfmt
from mgard_tpu_torch.ops import bitplane as tb, norms as tn
from mgard_tpu_torch.ops import quantize as tq, transform as tt

from test_torch_e2e import _field

TOL = 1e-2
SHAPE = (33, 33, 33)
# codec -> (dtype, JAX Config, port Config, the lossless it writes)
CODECS = {
    "segmented": (np.float32, JConfig(adapt_lossless=False),
                  mt.Config(adapt_lossless=False), mt.Lossless.BITPLANE),
    "pyramid": (np.float32, JConfig(layout=JLayout.PYRAMID,
                                    adapt_lossless=False),
                mt.Config(layout=mt.Layout.PYRAMID, adapt_lossless=False),
                mt.Lossless.BITPLANE),
    "pergroup": (np.float32, JConfig(), mt.Config(),
                 mt.Lossless.BITPLANE_GROUP),
    "wide": (np.float64, JConfig(), mt.Config(), mt.Lossless.BITPLANE),
}


def _coords(shape, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for s in shape:
        c = np.sort(rng.uniform(size=s)) if s > 1 else np.zeros(1)
        if s > 1:
            c[0], c[-1] = 0.0, 1.0
        out.append(c)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("shape,uniform", [((17, 1, 33), True),
                                           ((17, 1, 33), False),
                                           ((9, 20, 12), False)], ids=str)
def test_quantizer_matches_jax(shape, uniform, dtype):
    coords = None if uniform else _coords(shape)
    jh = JHierarchy(shape, coordinates=coords)
    th = THierarchy(shape, coordinates=coords)
    v = np.random.default_rng(1).standard_normal(shape).astype(dtype)
    pyr = tt.decompose(th, torch.from_numpy(v))
    for s in (0.0, 1.0, -1.0):
        tol = 1e-3
        ts = tq.scale_pyramid(th, pyr, s, tol)
        js = jq.scale_pyramid(jh, [jnp.asarray(p.numpy()) for p in pyr], s,
                              tol)
        int_dt = torch.int64 if dtype == np.float64 else torch.int32
        tint = [tq.round_quantize(x, int_dt) for x in ts]
        jint = [jq.round_quantize(x, jnp.int64 if dtype == np.float64
                                  else jnp.int32) for x in js]
        for a, b, c, d in zip(ts, js, tint, jint):
            assert a.dtype == pyr[0].dtype
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
            assert c.numpy().tobytes() == np.asarray(d).tobytes()
        td = tq.dequantize_pyramid(th, tint, s, tol, dtype)
        jd = jq.dequantize_pyramid(jh, jint, s, tol, dtype)
        for a, b in zip(td, jd):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
        assert any(c.abs().max() > 100 for c in tint)


def _snorm_err(th, out, v, s):
    return float(tn.norm(th, torch.from_numpy(out.astype(np.float64)
                                              - v.astype(np.float64)), s))


@pytest.mark.parametrize("s", [0.0, 1.0, -1.0], ids=str)
@pytest.mark.parametrize("codec", list(CODECS))
def test_roundtrip(codec, s, monkeypatch):
    dtype, _, cfg, lossless = CODECS[codec]
    v = _field(SHAPE, seed=2).astype(dtype)
    calls = {"K11": 0, "K4": 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped
    monkeypatch.setattr(tb, "bp_decode_condense",
                        counting("K11", tb.bp_decode_condense))
    monkeypatch.setattr(tb, "bp_decode_condense_f32",
                        counting("K4", tb.bp_decode_condense_f32))
    buf = mt.compress(v, TOL, s=s, config=cfg, device="cpu")
    header, _ = tfmt.read_container(buf)
    assert header.lossless == int(lossless) and header.s == s
    out = mt.decompress(buf, device="cpu")
    assert out.shape == v.shape and out.dtype == dtype
    th = THierarchy(SHAPE)
    err = _snorm_err(th, out, v, s)
    assert 0 < err <= TOL
    want = {"segmented": (th.L + 1, 0), "pyramid": (1, 0)}.get(codec,
                                                              (0, 0))
    assert (calls["K11"], calls["K4"]) == want
    # the L-infinity stream of the same field decodes through K4
    if codec == "segmented" and s == 0.0:
        mt.decompress(mt.compress(v, TOL, config=cfg, device="cpu"),
                      device="cpu")
        assert calls["K4"] == th.L + 1


def test_compressor_norm_by_s():
    v = torch.from_numpy(_field((17, 17, 17), seed=5))
    comp = mt.Compressor(THierarchy(v.shape), np.float32, s=1.0,
                         device="cpu")
    assert comp.norm(v).dtype == torch.float32
    assert float(comp.norm(v)) == float(
        np.sqrt(np.sum(v.numpy().astype(np.float64) ** 2)).astype(
            np.float32))
    linf = mt.Compressor(THierarchy(v.shape), np.float32, s=math.inf,
                         device="cpu")
    assert float(linf.norm(v)) == float(v.abs().max())
