"""mgard_tpu_torch's multi-block containers against mgard_tpu, on the CPU:
slabs of the largest dim (``max_block_bytes``), Variable slabs
(``dd_sizes``), N-D blocks (``dd_method="block"``), the REL norm taken
block by block, the planner, the pipeline depth, the block-to-device
mapping and ``release_cache``.

Each package decodes the other's container (the port with
``device="cpu"``), both write the same header choices and the same
container size, and every decode meets the bound: L-infinity <= tol for
s = inf; for s = 0 the JAX test's RMS bound ``sqrt(mean(err^2)) <= tol``
on slabs, and the s = 0 norm of the whole error on N-D blocks
(``tests/test_multiblock.py``'s bounds, no slack).  Shapes are few and
small, since each block shape is a JAX compile.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import mgard_tpu
import mgard_tpu.api as japi
from mgard_tpu.config import Config as JConfig
from mgard_tpu.parallel import domain as jdomain

import mgard_tpu_torch as mt
from mgard_tpu_torch import api
from mgard_tpu_torch.io import format as tfmt
from mgard_tpu_torch.models import compressor as tcomp
from mgard_tpu_torch.ops import norms
from mgard_tpu_torch.parallel import domain as tdomain

from test_torch_flat_e2e import _field

# Three slabs of (16, 33) each.
SLAB_SHAPE = (48, 33)


@pytest.fixture(autouse=True)
def one_jax_device(monkeypatch):
    """The JAX package spreads blocks over ``jax.local_devices()``, which
    ``tests/conftest.py`` makes eight CPU devices, and compiles each block's
    pipeline once a device.  Show it one device, as a one-card host is:
    the blocks' containers do not depend on where they ran."""
    first = jax.local_devices()[:1]
    monkeypatch.setattr(jax, "local_devices", lambda *a, **k: first)


def _both(v, tol, jcfg, tcfg, s=math.inf, mode="abs", coordinates=None):
    """Both packages' containers and headers for the same input."""
    bj = mgard_tpu.compress(v, tol, s=s, mode=mode, config=jcfg,
                            coordinates=coordinates)
    bt = mt.compress(v, tol, s=s, mode=mode, config=tcfg,
                     coordinates=coordinates, device="cpu")
    return bj, bt, tfmt.read_container(bj)[0], tfmt.read_container(bt)[0]


def _decodes(bj, bt):
    """Every decode: each package's own and the other's."""
    for buf in (bj, bt):
        yield mt.decompress(buf, device="cpu")
        yield mgard_tpu.decompress(buf)


def _same_header(hj, ht):
    fields = ("dd_nblocks", "dd_dim", "dd_edges", "dd_grid", "orig_shape",
              "tolerance", "lossless", "chunk_groups", "n_levels", "shape",
              "dtype", "error_mode", "s", "decomposition", "layout")
    assert {f: getattr(ht, f) for f in fields} \
        == {f: getattr(hj, f) for f in fields}


@pytest.mark.parametrize("s", [math.inf, 0.0], ids=["linf", "s0"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
def test_slabs_cross_decode(dtype, s):
    v = _field(SLAB_SHAPE, dtype, seed=90)
    tol = 1e-3
    cfg = dict(max_block_bytes=v.nbytes // 3 + 1)
    bj, bt, hj, ht = _both(v, tol, JConfig(**cfg), mt.Config(**cfg), s=s)
    assert ht.dd_nblocks == 3 and ht.dd_dim == 0 and ht.dd_edges is None
    _same_header(hj, ht)
    assert len(bt) == len(bj)
    for out in _decodes(bj, bt):
        assert out.shape == v.shape and out.dtype == v.dtype
        err = out.astype(np.float64) - v
        if math.isinf(s):
            assert np.abs(err).max() <= tol
        else:
            assert np.sqrt(np.mean(err ** 2)) <= tol


@pytest.mark.parametrize("s", [math.inf, 0.0], ids=["linf", "s0"])
def test_rel_norm_by_blocks(s):
    """REL takes each block's norm in the data's dtype and combines them
    on the host: the header's norm is the JAX package's, exactly for
    s = inf (a max of float32 values), within 1e-6 relative for s = 0
    (float64 sums in another order)."""
    v = 50.0 * _field(SLAB_SHAPE, seed=92)
    tol = 1e-3
    cfg = dict(max_block_bytes=v.nbytes // 3 + 1)
    bj, bt, hj, ht = _both(v, tol, JConfig(**cfg), mt.Config(**cfg), s=s,
                           mode="rel")
    assert ht.dd_nblocks == 3
    if math.isinf(s):
        assert ht.norm == hj.norm == float(np.abs(v).max())
        assert ht.tolerance == hj.tolerance
        for out in _decodes(bj, bt):
            assert np.abs(out - v).max() <= tol * ht.norm
    else:
        assert ht.norm == pytest.approx(hj.norm, rel=1e-6)
        assert ht.norm == pytest.approx(
            float(np.sqrt(np.sum(v.astype(np.float64) ** 2))), rel=1e-6)
        for out in _decodes(bj, bt):
            err = out.astype(np.float64) - v
            assert np.sqrt(np.mean(err ** 2)) <= tol * ht.norm


def test_variable_slabs_along_dim1():
    v = _field((20, 60), seed=91)
    tol = 1e-2
    cfg = dict(dd_sizes=(10, 30, 20), dd_dim=1)
    bj, bt, hj, ht = _both(v, tol, JConfig(**cfg), mt.Config(**cfg))
    assert ht.dd_nblocks == 3 and ht.dd_dim == 1
    assert ht.dd_edges == (0, 10, 40, 60)
    _same_header(hj, ht)
    assert len(bt) == len(bj)
    for out in _decodes(bj, bt):
        assert np.abs(out - v).max() <= tol
    with pytest.raises(ValueError, match="dd_sizes"):
        mt.compress(v, tol, config=mt.Config(dd_sizes=(10, 10), dd_dim=1),
                    device="cpu")


@pytest.mark.parametrize("s", [math.inf, 0.0], ids=["linf", "s0"])
def test_nd_blocks_cross_decode(s):
    shape = (34, 33, 9)
    v = _field(shape, seed=11)
    tol = 1e-2
    cfg = dict(dd_method="block", block_edge=17)
    bj, bt, hj, ht = _both(v, tol, JConfig(**cfg), mt.Config(**cfg), s=s)
    assert ht.dd_grid == (2, 2, 1) and ht.dd_nblocks == 4
    _same_header(hj, ht)
    assert len(bt) == len(bj)
    hier = mt.Hierarchy(shape)
    for out in _decodes(bj, bt):
        err = out.astype(np.float64) - v
        if math.isinf(s):
            assert np.abs(err).max() <= tol
        else:
            assert float(norms.norm(hier, torch.from_numpy(err), s)) <= tol


def test_nd_blocks_nonuniform_coordinates():
    shape = (20, 9)
    rng = np.random.default_rng(3)
    coords = []
    for n in shape:
        c = np.sort(rng.uniform(size=n))
        c[0], c[-1] = 0.0, 1.0
        coords.append(c)
    v = _field(shape, seed=3)
    tol = 1e-2
    cfg = dict(dd_method="block", block_edge=10)
    bj, bt, hj, ht = _both(v, tol, JConfig(**cfg), mt.Config(**cfg),
                           coordinates=coords)
    assert ht.dd_grid == (2, 1) and not ht.uniform
    _same_header(hj, ht)
    for c_t, c_j in zip(ht.coordinates, hj.coordinates):
        assert np.array_equal(c_t, c_j)
    for out in _decodes(bj, bt):
        assert np.abs(out - v).max() <= tol


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_depth_keeps_bytes(monkeypatch, depth):
    """MGARD_TPU_PIPELINE_DEPTH counts as in the JAX package (at least
    one more than the devices); any number of blocks in flight, 1 (the
    serial order, which no setting gives) included, writes the default
    container and decodes it alike; a tensor input writes the numpy
    input's."""
    v = _field(SLAB_SHAPE, seed=7)
    cfg = mt.Config(max_block_bytes=v.nbytes // 3 + 1)
    ref = mt.compress(v, 1e-3, config=cfg, device="cpu")
    ref_out = mt.decompress(ref, device="cpu")
    monkeypatch.setattr(api, "_PIPELINE_DEPTH", depth)
    assert api._pipeline_depth(1) == max(depth, 2)
    monkeypatch.setattr(api, "_pipeline_depth", lambda ndev: depth)
    buf = mt.compress(torch.from_numpy(v), 1e-3, config=cfg, device="cpu")
    assert buf == ref
    assert np.array_equal(mt.decompress(buf, device="cpu"), ref_out)


def test_blocks_cycle_over_devices(monkeypatch):
    """With several cards and no device, block i goes to cuda:{i % ndev}
    on encode and decode (the devices faked, the work on the CPU); an
    explicit device takes every block."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = [torch.device("cuda", k) for k in range(3)]
    assert api.block_devices() == cards
    assert api.block_devices("cuda:1") == [torch.device("cuda", 1)]
    assert api.block_devices("cpu") == [torch.device("cpu")]
    assert api._pipeline_depth(3) == max(api._PIPELINE_DEPTH, 4)

    asked = []
    real = api.get_compressor

    def on_cpu(*args, device, **kw):
        asked.append(torch.device(device))
        return real(*args, device="cpu", **kw)

    monkeypatch.setattr(api, "get_compressor", on_cpu)
    v = _field(SLAB_SHAPE, seed=8)
    cfg = mt.Config(max_block_bytes=v.nbytes // 4 + 1,
                    max_memory_footprint=1 << 30)
    buf = mt.compress(v, 1e-3, config=cfg)
    # the probe on the first device, then the four slabs
    assert asked == cards[:1] + cards + cards[:1]
    asked.clear()
    out = mt.decompress(buf)
    assert asked == cards + cards[:1]
    assert np.abs(out - v).max() <= 1e-3
    asked.clear()
    mt.compress(v, 1e-3, config=cfg, device="cuda:2")
    assert asked == [torch.device("cuda", 2)] * 5


def _jax_rule(shape, dtype, est, block_bytes, budget) -> int:
    """``mgard_tpu.api.plan_blocks``' rule on a given estimate."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    nb = max(2, -(-est // budget)) if est > budget else 1
    return min(max(nb, -(-nbytes // block_bytes)), max(shape))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(65, 65, 65), (1024, 1024, 1024),
                                   (16, 4096, 4096), (3, 1 << 28),
                                   (7, 5, 1 << 26)], ids=str)
@pytest.mark.parametrize("caps", [(2 << 30, 0), (1 << 20, 0),
                                  (2 << 30, 1 << 30), (1 << 26, 3 << 30)],
                         ids=str)
def test_plan_blocks_matches_jax(shape, dtype, caps):
    """float32 shapes without a per-dim level take the JAX package's
    estimate and plan.  float64 data, shapes with a dim over 4096
    nodes (whose levels take the per-dim form) and float32 shapes under
    2^22 values (the per-group codec) take the port's measured
    peak times 1.15: the JAX estimate scaled by that over its 3.9 x 1.15,
    planned by the JAX package's rule (the test's copy of the rule held
    against the JAX package's plan on its own estimate), never into
    fewer blocks than the JAX package."""
    block_bytes, footprint = caps
    jcfg = JConfig(max_block_bytes=block_bytes,
                   max_memory_footprint=footprint)
    tcfg = mt.Config(max_block_bytes=block_bytes,
                     max_memory_footprint=footprint)
    est = mt.estimate_memory_footprint(shape, dtype)
    plan = api.plan_blocks(shape, dtype, tcfg, "cpu")
    est_j = mgard_tpu.estimate_memory_footprint(shape, dtype)
    plan_j = japi.plan_blocks(shape, dtype, jcfg)
    budget = footprint or japi._device_memory_budget()
    assert _jax_rule(shape, dtype, est_j, block_bytes, budget) == plan_j
    peaks = [api.PEAK_PER_BYTE["per_dim"]] if max(shape) > 4096 else []
    if dtype == np.float64:
        peaks.append(api.PEAK_PER_BYTE["wide"])
    elif np.prod(shape) < 1 << 22:
        peaks.append(api.PEAK_PER_BYTE["grouped"])
    if not peaks:
        assert api.footprint_per_byte(shape, dtype) == api.FOOTPRINT_PER_BYTE
        assert est == est_j and plan == plan_j
    else:
        factor = 1.15 * max(peaks)
        assert api.footprint_per_byte(shape, dtype) == factor
        ratio = factor / (3.9 * 1.15)
        assert abs(est - ((est_j - (32 << 20)) * ratio + (32 << 20))) \
            <= ratio + 1
        assert est > est_j
        assert plan == _jax_rule(shape, dtype, est, block_bytes, budget)
        assert plan >= plan_j


def test_domain_module_matches_jax():
    for tol, s, n in ((1e-3, math.inf, 4), (1e-3, 0.0, 4), (2.0, 1.0, 3)):
        assert tdomain.local_abs_tol(tol, s, n) \
            == jdomain.local_abs_tol(tol, s, n)
    assert tdomain.block_grid_blocks((34, 33, 5), (2, 3, 1)) \
        == jdomain.block_grid_blocks((34, 33, 5), (2, 3, 1))
    for args in (((64, 64), 1 << 30, 4), ((1000, 10), 10000, 4),
                 ((40, 50, 30), 20000, 8, "block", 16)):
        t, j = tdomain.DomainDecomposer(*args), jdomain.DomainDecomposer(*args)
        assert t.blocks == j.blocks and len(t) == len(j)
        assert [t.slices(i) for i in range(len(t))] \
            == [j.slices(i) for i in range(len(j))]


def test_release_cache_empties_the_compressor_cache():
    mt.get_compressor((9, 9), np.float32, device="cpu")
    assert tcomp._cached_compressor.cache_info().currsize > 0
    mt.release_cache()
    assert tcomp._cached_compressor.cache_info().currsize == 0


def test_release_cache_frees_device_and_pinned_memory(monkeypatch):
    """With CUDA initialized (faked here), release_cache empties the
    device cache and the pinned host cache, and every API call empties
    the pinned host cache before it returns."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: calls.append("device"))
    if hasattr(torch, "accelerator") \
            and hasattr(torch.accelerator, "empty_host_cache"):
        monkeypatch.setattr(torch.accelerator, "empty_host_cache",
                            lambda: calls.append("pinned"))
    else:
        monkeypatch.setattr(torch._C, "_host_emptyCache",
                            lambda: calls.append("pinned"), raising=False)
    mt.release_cache()
    assert calls == ["device", "pinned"]
    calls.clear()
    v = _field((9, 9), seed=9)
    buf = mt.compress(v, 1e-3, device="cpu")
    mt.decompress(buf, device="cpu")
    assert calls == ["pinned", "pinned"]


def test_config_replace():
    cfg = mt.Config(max_block_bytes=1 << 20)
    new = cfg.replace(lossless=mt.Lossless.BITPLANE_GROUP,
                      adapt_lossless=False)
    assert (new.lossless, new.adapt_lossless, new.max_block_bytes) \
        == (mt.Lossless.BITPLANE_GROUP, False, 1 << 20)
    assert (cfg.lossless, cfg.adapt_lossless) \
        == (mt.Lossless.BITPLANE, True)
    with pytest.raises(TypeError):
        cfg.replace(no_such_field=1)


def test_corrupted_block_containers_rejected():
    v = _field(SLAB_SHAPE, seed=9)
    buf = mt.compress(v, 1e-3, device="cpu",
                      config=mt.Config(max_block_bytes=v.nbytes // 3 + 1))
    header, sections = tfmt.read_container(buf)
    with pytest.raises(ValueError, match="multiple"):
        mt.decompress(tfmt.write_container(header, sections[:-1]),
                      device="cpu")
    for bad in (dict(dd_edges=(0, 10, 48)), dict(dd_edges=(0, 30, 20, 48)),
                dict(dd_dim=2)):
        with pytest.raises(ValueError, match="corrupted"):
            mt.decompress(tfmt.write_container(
                dataclasses.replace(header, **bad), sections), device="cpu")
    with pytest.raises(ValueError, match="multi-block"):
        api.compressor_for(header, "cpu")


def test_planner_counts_the_per_group_peak():
    """The per-group codec (float32 under 2^22 values with a chunked
    lossless, or a grouped lossless at any size) is planned at its
    measured peak; float64 and a domain the codec does not reach are
    not."""
    grouped = 1.15 * api.PEAK_PER_BYTE["grouped"]
    assert api.footprint_per_byte((128,) * 3, np.float32) == grouped
    assert api.footprint_per_byte((255, 128, 128), np.float32, mt.Config(
        lossless=mt.Lossless.BITPLANE_LZ4)) == grouped
    assert api.footprint_per_byte((512,) * 3, np.float32, mt.Config(
        lossless=mt.Lossless.BITPLANE_GROUP)) == grouped
    assert api.footprint_per_byte((256, 128, 128), np.float32) \
        == api.FOOTPRINT_PER_BYTE
    assert api.footprint_per_byte((128,) * 3, np.float32, mt.Config(
        adapt_lossless=False)) == api.FOOTPRINT_PER_BYTE
    assert api.footprint_per_byte((128,) * 3, np.float32, mt.Config(
        lossless=mt.Lossless.NONE)) == 1.15 * api.PEAK_PER_BYTE["host"]
    assert api.footprint_per_byte((128,) * 3, np.float64) \
        == 1.15 * api.PEAK_PER_BYTE["wide"]
