"""mgard_tpu_torch end to end against mgard_tpu: the default Config at
>= 2^22 values, and REL mode on a nonuniform grid (cross-decoded both
ways within the bound; see test_torch_e2e.py for why bytes are not
compared).  Kept apart from test_torch_e2e.py so the two files' JAX
compiles run on separate test workers."""

import math

import numpy as np

import mgard_tpu_torch as mt
from mgard_tpu.config import Config as JConfig, Lossless as JLossless
from mgard_tpu_torch.io import format as tfmt

from test_torch_e2e import _cross_check, _field


def test_cross_decode_rel_and_nonuniform():
    shape = (33, 40, 17)
    rng = np.random.default_rng(2)
    coords = [np.sort(rng.uniform(0, 3, s)) for s in shape]
    v = _field(shape, seed=2)
    _cross_check(v, 1e-3, JConfig(adapt_lossless=False),
                 mt.Config(adapt_lossless=False), mode="rel",
                 coordinates=coords)


def test_cross_decode_default_config_large():
    """The default Config at >= 2^22 values keeps the chunked BITPLANE
    codec (the adapt_lossless switch does not fire)."""
    shape = (162, 162, 162)
    assert math.prod(shape) >= 1 << 22
    v = _field(shape, seed=1)
    bj, bt = _cross_check(v, 1e-3, None, None)
    assert tfmt.read_container(bt)[0].lossless == int(JLossless.BITPLANE)
    assert mt.get_compressor(shape, np.float32,
                             device="cpu").lossless == mt.Lossless.BITPLANE
