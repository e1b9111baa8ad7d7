"""mgard_tpu_torch's two-kernel segmented encode (K16 ``bp_quant_zigzag``,
K17 ``bp_condense_into``) against mgard_tpu's Pallas kernels in
interpret mode and against the port's K2/K3, on the CPU.  Integer stages,
so every comparison is bit for bit.

* K16's words, maxima and statuses equal the JAX kernel's, with a NaN,
  infinities, values past the int32 range and the largest value that
  still rounds below 2^31 planted: where the status is not 0, the words
  are those of XLA's saturating cast (NaN -> 0, the int32 maximum or
  minimum past its range).
* K17 chains two segments into one stream buffer at global row offsets,
  as the JAX kernel does through its aliased buffer.
* On the port alone, K16's maxima and statuses equal K2's, and K17 o K16
  writes the stream that K2 + K3 (``encode_segments``) write.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from mgard_tpu.ops import pallas_kernels as pk

from mgard_tpu_torch.ops import bitplane as tb
from mgard_tpu_torch.ops import bp_kernels as bk

from test_torch_codec import _segments

# the largest float32 below 2^31: |x| + 0.5 rounds back to it
BELOW_2_31 = 2147483520.0


def _planted(C, nchunks, inv_q, seed=0):
    """A segment of a little under ``nchunks`` chunks, scaled so that its
    words span many bit lengths, with chunk 0 holding a NaN, chunk 1 both
    infinities, chunk 2 values past the int32 range either way and the
    last chunk +-BELOW_2_31 (after scaling; its status stays 0)."""
    n = nchunks * 32 * C - 77
    rng = np.random.default_rng(seed)
    seg = (rng.normal(size=n) * rng.choice([0.0, 1.0, 40.0, 3e6], size=n)
           ).astype(np.float32)
    chunk = 32 * C
    seg[5] = np.nan
    seg[chunk + 7], seg[chunk + 9] = np.inf, -np.inf
    seg[2 * chunk + 3], seg[2 * chunk + 4] = 3e9 / inv_q, -3e9 / inv_q
    last = (nchunks - 1) * chunk
    seg[last + 1], seg[last + 2] = BELOW_2_31 / inv_q, -BELOW_2_31 / inv_q
    return seg


def _jax_chunks(seg, nchunks, C):
    return bk.chunked(torch.from_numpy(seg), nchunks, C).numpy()


@pytest.mark.parametrize("C,nchunks,inv_q", [(128, 8, 1.0), (256, 4, 0.5),
                                              (4096, 4, 1.0)],
                         ids=str)
def test_quant_zigzag_matches_pallas(C, nchunks, inv_q):
    seg = _planted(C, nchunks, inv_q)
    with pltpu.force_tpu_interpret_mode():
        jz, jmax, jst = pk.bp_quant_zigzag(
            jnp.asarray(_jax_chunks(seg, nchunks, C)), inv_q)
    z, zmax, status = bk.bp_quant_zigzag(torch.from_numpy(seg), nchunks, C,
                                         inv_q)
    assert z.shape == (nchunks, 32, C) and z.dtype == torch.int32
    assert z.numpy().tobytes() == np.asarray(jz).tobytes()
    assert zmax.numpy().tobytes() == np.asarray(jmax).tobytes()
    assert status.tolist() == np.asarray(jst).tolist()
    assert status.tolist()[:3] == [2, 2, 1] and status.tolist()[-1] == 0
    # the saturated words, and the last one below the range
    w = z.numpy().reshape(-1).view(np.uint32)
    chunk, last = 32 * C, (nchunks - 1) * 32 * C
    assert [int(w[i]) for i in (5, chunk + 7, chunk + 9, 2 * chunk + 3,
                                2 * chunk + 4, last + 1, last + 2)] \
        == [0, 0xFFFFFFFE, 0xFFFFFFFF, 0xFFFFFFFE, 0xFFFFFFFF,
            2 * int(BELOW_2_31), 2 * int(BELOW_2_31) - 1]


def test_condense_into_matches_pallas():
    """Two segments condensed into one buffer, each at its global row
    offsets: the words equal the JAX kernel's over [0, total_rows)."""
    C = 128
    segs = _segments([20000, 9000], seed=2)
    ncs = [tb.num_chunks_tiled(s.size, C) for s in segs]
    cap_rows = sum(ncs) * 33
    buf = jnp.zeros((cap_rows, C // 128, 128), jnp.uint32)
    words = torch.zeros(cap_rows * C, dtype=torch.int32)
    base = 0
    for seg, nc in zip(segs, ncs):
        z, zmax, status = bk.bp_quant_zigzag(torch.from_numpy(seg), nc, C,
                                             1.0)
        assert not status.any()
        e = tb._bit_length32(zmax)
        offsets = (tb._offsets(e) + base).to(torch.int32)
        total = base + int(e.sum())
        with pltpu.force_tpu_interpret_mode():
            buf = pk.bp_condense_into(
                jnp.asarray(z.numpy().view(np.uint32)),
                jnp.asarray(offsets.numpy()), jnp.asarray(total, jnp.int32),
                buf)
        bk.bp_condense_into(z, offsets, e, words)
        base = total
    assert base > 0 and words[base * C:].eq(0).all()
    got = words[:base * C].numpy().view(np.uint32)
    assert got.tobytes() == np.asarray(buf).reshape(-1)[:base * C].tobytes()


@pytest.mark.parametrize("C", [128, 512])
def test_split_equals_fused_encode(C):
    """K17 o K16 per segment writes ``encode_segments``'s stream (K2 +
    K3), and K16's maxima and statuses equal K2's."""
    segs = _segments([3000, 9 ** 3, 40000, 1], seed=3)
    inv_q = float(np.float32(1 / 0.37))
    e, words, count, status = tb.encode_segments(
        [torch.from_numpy(s) for s in segs], inv_q, C=C)
    assert int(status) == 0
    ncs = [tb.num_chunks_tiled(s.size, C) for s in segs]
    split = torch.zeros_like(words)
    zmaxs = []
    for seg, nc in zip(segs, ncs):
        t = torch.from_numpy(seg)
        z, zmax, st = bk.bp_quant_zigzag(t, nc, C, inv_q)
        k2max, k2st = bk.bp_quant_max(t, nc, C, inv_q)
        assert torch.equal(zmax, k2max) and torch.equal(st, k2st)
        zmaxs.append((z, zmax))
    e2 = tb._bit_length32(torch.cat([m for _, m in zmaxs]))
    assert torch.equal(e2.to(torch.uint8), e)
    offsets = tb._offsets(e2)
    a = 0
    for (z, _), nc in zip(zmaxs, ncs):
        bk.bp_condense_into(z, offsets[a:a + nc], e2[a:a + nc], split)
        a += nc
    assert torch.equal(split, words)
    assert int(count) == int(e2.sum()) * C


def test_status_equals_k2_on_planted_values():
    seg = torch.from_numpy(_planted(128, 8, 1.0))
    _, _, status = bk.bp_quant_zigzag(seg, 8, 128, 1.0)
    assert torch.equal(status, bk.bp_quant_max(seg, 8, 128, 1.0)[1])


def test_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="larger"):
        bk.bp_quant_zigzag(torch.zeros(1000), 1, 16, 1.0)
    with pytest.raises(ValueError, match="float32"):
        bk.bp_quant_zigzag(torch.zeros(10, dtype=torch.float64), 1, 128, 1.0)
    i32 = torch.zeros(4 * 33 * 128, dtype=torch.int32)
    with pytest.raises(ValueError, match="z must be"):
        bk.bp_condense_into(torch.zeros(4, 32, 128), i32[:4], i32[:4], i32)
    with pytest.raises(ValueError, match="one entry per chunk"):
        bk.bp_condense_into(i32[:4 * 32 * 128].view(4, 32, 128), i32[:3],
                            i32[:4], i32)
    with pytest.raises(ValueError, match="whole"):
        bk.bp_condense_into(i32[:4 * 32 * 128].view(4, 32, 128), i32[:4],
                            i32[:4], i32[:100])
