"""Two repairs of the port, held against ``mgard_tpu`` on the CPU.

* The MGARD-X Huffman decode tables the code at every bit position of
  one group of chunks at a time (``io/mgard_compat._x_chunk_groups``),
  so its memory is bounded by ``_X_GROUP_BITS``, not by the stream: with
  a small budget patched in it gives the whole-stream decode bit for
  bit.
* ``Compressor.decompress(buf)`` reads the container and decodes it: the
  same array as ``api.decompress(buf)``, and a JAX container within its
  tolerance.

Inputs are made from numpy seeds.
"""

import math

import numpy as np
import pytest

import mgard_tpu
import mgard_tpu_torch as mt
from mgard_tpu.io import mgard_compat as jmc
from mgard_tpu_torch.io import mgard_compat as pmc
from mgard_tpu_torch.models.compressor import get_compressor


def _stream(n, seed, spread=300, outlier_every=997):
    rng = np.random.default_rng(seed)
    q = np.round(rng.standard_normal(n) * spread).astype(np.int64)
    q[::outlier_every] = 10 ** 6
    return q


def _field(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape],
                        indexing="ij")
    v = sum(np.cos(np.pi * k * g) for k, g in enumerate(grids, 1))
    return (v + 1e-3 * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("budget", [1, 3000, 20000, 1 << 16])
def test_x_decode_in_groups_bit_for_bit(budget, monkeypatch):
    """30 chunks of 1000 symbols (~9-10 kbit each): a budget under one
    chunk gives a group a chunk, larger ones group several; each decode
    is the whole-stream one bit for bit and the JAX package's stream."""
    q = _stream(30000, seed=5)
    blob = jmc._encode_x_huffman(q, chunk_size=1000)
    whole = pmc._decode_x_huffman(blob, "cpu").numpy()
    assert np.array_equal(whole, q)
    seen = []
    groups = pmc._x_chunk_groups

    def spy(bits, entries, b):
        seen.append(groups(bits, entries, b))
        return seen[-1]

    monkeypatch.setattr(pmc, "_X_GROUP_BITS", budget)
    monkeypatch.setattr(pmc, "_x_chunk_groups", spy)
    got = pmc._decode_x_huffman(blob, "cpu").numpy()
    assert got.tobytes() == whole.tobytes()
    (used,) = seen
    assert used[0][0] == 0 and used[-1][1] == 30
    assert all(a[1] == b[0] for a, b in zip(used, used[1:]))
    if budget < 1 << 16:
        assert len(used) > 1
    if budget == 1:
        assert len(used) == 30


def test_chunk_groups_fit_the_budget():
    rng = np.random.default_rng(0)
    bits = rng.integers(100, 5000, size=200)
    entries = np.concatenate([[0], np.cumsum((bits + 63) // 64)[:-1]])
    for budget in (1, 4096, 50000, 1 << 40):
        groups = pmc._x_chunk_groups(bits, entries, budget)
        assert [g[0] for g in groups[1:]] == [g[1] for g in groups[:-1]]
        for c0, c1 in groups:
            span = (entries[c1 - 1] * 64 + bits[c1 - 1]) - entries[c0] * 64
            assert span <= budget or c1 - c0 == 1
            if c1 < len(bits):      # the next chunk would not have fit
                nxt = entries[c1] * 64 + bits[c1] - entries[c0] * 64
                assert nxt > budget
    assert pmc._x_chunk_groups(bits, entries, 1 << 40) == [(0, 200)]


def test_x_buffer_decodes_in_groups(monkeypatch):
    """A whole MGARD-X buffer of the JAX writer decodes the same with a
    budget that splits its stream into groups."""
    v = _field((33, 33, 33), seed=2)
    buf = jmc.compress_mgard_x(v, 1e-2, chunk_size=4096)
    whole = mt.decompress(buf, device="cpu")
    seen = []
    groups = pmc._x_chunk_groups
    monkeypatch.setattr(pmc, "_X_GROUP_BITS", 2048)
    monkeypatch.setattr(pmc, "_x_chunk_groups", lambda *a: seen.append(
        groups(*a)) or seen[-1])
    got = mt.decompress(buf, device="cpu")
    assert got.tobytes() == whole.tobytes()
    assert seen and all(len(g) > 1 for g in seen)
    assert np.abs(got - v).max() <= 1e-2


@pytest.mark.parametrize("shape,dtype,s", [((33, 33, 33), np.float32,
                                            math.inf),
                                           ((17, 40), np.float64, 0.0)],
                         ids=str)
def test_compressor_decompress_equals_api(shape, dtype, s):
    v = _field(shape, seed=1, dtype=dtype)
    buf = mt.compress(v, 1e-3, s=s, device="cpu")
    comp = get_compressor(shape, dtype, s=s, device="cpu")
    got = comp.decompress(buf)
    want = mt.decompress(buf, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_compressor_decompress_reads_a_jax_container():
    shape, tol = (33, 33, 33), 1e-3
    v = _field(shape, seed=3)
    buf = mgard_tpu.compress(v, tol)
    header, _ = mt.io.format.read_container(buf)
    comp = get_compressor(shape, np.float32,
                          chunk_groups=header.chunk_groups or 2048,
                          device="cpu")
    got = comp.decompress(buf)
    assert got.shape == shape
    assert np.abs(got - v).max() <= tol
    assert np.array_equal(got, mt.decompress(buf, device="cpu"))
