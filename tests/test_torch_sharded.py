"""mgard_tpu_torch's ShardedCompressor against the port's multi-block API
and mgard_tpu's ShardedCompressor, on the CPU.

The port's class takes a list of devices in one process (here
``["cpu"] * k``) and places the blocks on them in contiguous runs, as
the JAX class's ``P(axis)`` does on a mesh.  Its container is the one
``mgard_tpu_torch.compress`` writes for the same slabs, byte for byte;
containers of the two classes decode in both packages within the
tolerance.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import mgard_tpu
from mgard_tpu.config import ErrorMode as JErrorMode
from mgard_tpu.parallel.sharded import ShardedCompressor as JSharded

import mgard_tpu_torch as mt
from mgard_tpu_torch.config import ErrorMode
from mgard_tpu_torch.io import format as fmt
from mgard_tpu_torch.parallel import ShardedCompressor

GLOBAL = (64, 17, 33)


def _field(shape, seed):
    x = [np.linspace(0.0, 1.0, n) for n in shape]
    v = np.cos(3 * x[0])[:, None, None] * np.sin(2 * x[1])[None, :, None] \
        * (1 + x[2])[None, None, :]
    return (v + 1e-3 * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_sharded_roundtrip_8_devices():
    """8 blocks of (9, 9) over eight devices (tests/test_parallel.py's
    case): encode and decode within the tolerance, one block a device."""
    sc = ShardedCompressor(["cpu"] * 8, (9, 9), np.float32)
    rng = np.random.default_rng(30)
    v = rng.normal(size=(8, 9, 9)).astype(np.float32)
    e, w, c, st, block_tol = sc.encode(v, 1e-2)
    assert len(e) == len(w) == len(c) == len(st) == 8
    assert all(int(x) == 0 for x in st) and block_tol == 1e-2
    out = np.stack([o.numpy() for o in sc.decode(e, w, block_tol)])
    assert np.abs(out - v).max() <= 1e-2
    step = sc.roundtrip_step()
    err, words = step(sc.shard_blocks(v), block_tol)
    assert float(err) <= 1e-2 and int(words) == sum(int(x) for x in c)


def test_blocks_are_placed_in_contiguous_runs():
    sc = ShardedCompressor(["cpu"] * 2, (9, 9), np.float32)
    assert sc._placement(8) == [0, 0, 0, 0, 1, 1, 1, 1]
    assert len(sc.comps) == 2 and sc.comp is sc.comps[0]
    with pytest.raises(ValueError, match="do not split evenly"):
        sc.encode(np.zeros((3, 9, 9), np.float32), 1e-2)
    with pytest.raises(ValueError, match="expected blocks"):
        sc.shard_blocks(np.zeros((2, 9, 8), np.float32))
    with pytest.raises(ValueError, match="not divisible"):
        ShardedCompressor.for_global(["cpu"], (63, 17), np.float32,
                                     nblocks=2)
    with pytest.raises(ValueError, match="do not split evenly"):
        ShardedCompressor.for_global(["cpu"] * 2, (63, 17), np.float32,
                                     nblocks=3)


@pytest.mark.parametrize("s,mode", [(math.inf, ErrorMode.ABS),
                                    (math.inf, ErrorMode.REL),
                                    (0.0, ErrorMode.ABS)], ids=str)
def test_for_global_is_the_api_container(s, mode):
    """for_global's container is the multi-block API's for the same slabs
    (max_block_bytes a quarter of the field), byte for byte."""
    v = _field(GLOBAL, 5)
    sc = ShardedCompressor.for_global(["cpu"] * 2, GLOBAL, np.float32, s=s,
                                      nblocks=4)
    buf = sc.compress(v, 1e-3, mode=mode)
    ref = mt.compress(v, 1e-3, s=s, mode=mode.name.lower(), device="cpu",
                      config=mt.Config(max_block_bytes=v.nbytes // 4))
    assert buf == ref
    header = fmt.read_container(buf)[0]
    assert (header.dd_nblocks, header.dd_dim) == (4, 0)
    out = mt.decompress(buf, device="cpu")
    if math.isinf(s):
        assert np.abs(out - v).max() <= header.tolerance
    # a torch input writes the same bytes
    assert sc.compress(torch.from_numpy(v), 1e-3, mode=mode) == buf


@pytest.mark.parametrize("s", [math.inf, 0.0], ids=str)
def test_rel_and_cross_decodes_with_the_jax_class(s):
    """REL mode: the norm of the JAX class's pmax / psum (equal to its
    header's within float32 rounding); each class's container decodes in
    both packages within the tolerance (checked at L-infinity; the s = 0
    bound by the port's norms on the whole grid)."""
    v = _field(GLOBAL, 6)
    mesh = Mesh(np.array(jax.devices()[:2]), ("blocks",))
    jsc = JSharded.for_global(mesh, "blocks", GLOBAL, np.float32, s=s)
    jbuf = jsc.compress(v, 1e-3, mode=JErrorMode.REL)
    sc = ShardedCompressor.for_global(["cpu"] * 2, GLOBAL, np.float32, s=s)
    buf = sc.compress(v, 1e-3, mode=ErrorMode.REL)
    jh, th = fmt.read_container(jbuf)[0], fmt.read_container(buf)[0]
    assert th.norm == pytest.approx(jh.norm, rel=1e-6)
    assert th.tolerance == pytest.approx(jh.tolerance, rel=1e-6)
    for f in ("dd_nblocks", "dd_dim", "lossless", "chunk_groups", "shape",
              "decomposition", "layout"):
        assert getattr(th, f) == getattr(jh, f)
    bound = 1e-3 * th.norm
    from mgard_tpu_torch.hierarchy import Hierarchy
    from mgard_tpu_torch.ops import norms
    for b in (jbuf, buf):
        for out in (np.asarray(mgard_tpu.decompress(b)),
                    mt.decompress(b, device="cpu")):
            if math.isinf(s):
                assert np.abs(out - v).max() <= bound
            else:
                d = torch.from_numpy(out.astype(np.float64) - v)
                assert float(norms.norm(Hierarchy(GLOBAL), d, s)) <= bound


def test_needs_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedCompressor(None, (9, 9), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedCompressor.for_global(["cuda:0"], (64, 9), np.float32)
