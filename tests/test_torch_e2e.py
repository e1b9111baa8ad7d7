"""mgard_tpu_torch end to end against mgard_tpu, on the CPU.

Container bytes are not canonical across implementations (the transform's
float32 sums run in another order, which can move a coefficient across a
quantization bin edge; doc/FORMAT.md), so the packages are compared by
cross-decoding: each decodes the other's containers within the error
bound, in both directions, and the port's own round trip stays within it.
"""

import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mgard_tpu
from mgard_tpu.config import Config as JConfig, Lossless as JLossless

import mgard_tpu_torch as mt
from mgard_tpu_torch.io import format as tfmt

ROOT = Path(__file__).resolve().parent.parent


def _field(shape, seed=0):
    """A smooth field plus noise (bench.py's form, at a small size)."""
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


def _cross_check(v, tol, jcfg, tcfg, mode="abs", coordinates=None):
    bj = mgard_tpu.compress(v, tol, mode=mode, config=jcfg,
                            coordinates=coordinates)
    bt = mt.compress(v, tol, mode=mode, config=tcfg,
                     coordinates=coordinates, device="cpu")
    bound = tol * (float(np.abs(v).max()) if mode == "rel" else 1.0)
    for buf in (bj, bt):
        for out in (mt.decompress(buf, device="cpu"),
                    mgard_tpu.decompress(buf)):
            assert out.shape == v.shape and out.dtype == np.float32
            assert np.abs(out - v).max() <= bound
    hj, _ = tfmt.read_container(bj)
    ht, _ = tfmt.read_container(bt)
    assert (ht.lossless, ht.layout, ht.chunk_groups, ht.n_levels) == (
        hj.lossless, hj.layout, hj.chunk_groups, hj.n_levels)
    assert ht.tolerance == hj.tolerance and ht.norm == hj.norm
    return bj, bt


@pytest.mark.parametrize("shape", [(65, 65, 65), (129, 129, 129)], ids=str)
def test_cross_decode_chunked_codec(shape):
    v = _field(shape)
    _cross_check(v, 1e-3, JConfig(adapt_lossless=False),
                 mt.Config(adapt_lossless=False))


def test_status_errors():
    v = _field((33, 33, 33))
    cfg = mt.Config(adapt_lossless=False)
    bad = v.copy()
    bad[3, 4, 5] = np.nan
    with pytest.raises(ValueError, match="NaN or Inf"):
        mt.compress(bad, 1e-3, config=cfg, device="cpu")
    with pytest.raises(OverflowError):
        mt.compress(v * 1e8, 1e-6, config=cfg, device="cpu")


def test_unported_branches_raise():
    """Malformed buffers of ported branches are refused.  Reference MGARD
    buffers are ported (their cross-decodes are in
    test_torch_interop.py): a zero-length header, whose CRC passes, lacks
    its ``domain`` and is refused with a ValueError naming it (the JAX
    package raises KeyError there).  Every lossless and ROI containers are
    ported (test_torch_hostcodec.py, test_torch_roi.py), so those headers
    with empty sections are refused as corrupted."""
    v = _field((33, 33, 33))
    with pytest.raises(ValueError, match="domain"):
        mt.decompress(b"MGARD" + bytes(64), device="cpu")
    huffman = tfmt.write_container(tfmt.Header(
        dtype=np.float32, shape=v.shape, uniform=True, coordinates=None,
        error_mode=0, s=math.inf, tolerance=1e-3, norm=1.0,
        lossless=int(JLossless.HUFFMAN_ZLIB), n_levels=5,
        section_sizes=(), layout=3, chunk_groups=4096), [b""])
    with pytest.raises(ValueError, match="corrupted"):
        mt.decompress(huffman, device="cpu")
    roi = tfmt.write_container(tfmt.Header(
        dtype=np.float32, shape=v.shape, uniform=True, coordinates=None,
        error_mode=0, s=math.inf, tolerance=1e-3, norm=1.0,
        lossless=int(JLossless.BITPLANE_GROUP), n_levels=5,
        section_sizes=(), layout=3, chunk_groups=4096, roi_block=8),
        [b"", b""])
    with pytest.raises(ValueError, match="corrupted"):
        mt.decompress(roi, device="cpu")         # ROI containers


def test_corrupted_stream_rejected():
    v = _field((33, 33, 33))
    buf = mt.compress(v, 1e-3, config=mt.Config(adapt_lossless=False),
                      device="cpu")
    header, sections = tfmt.read_container(buf)
    short = tfmt.write_container(header, [sections[0], sections[1][:-4]])
    with pytest.raises(ValueError, match="corrupted"):
        mt.decompress(short, device="cpu")


def test_tensor_input_and_compressor_api():
    v = _field((33, 33, 33), seed=5)
    comp = mt.Compressor(mt.Hierarchy(v.shape), np.float32,
                         config=mt.Config(adapt_lossless=False),
                         device="cpu")
    buf = comp.compress(torch.from_numpy(v), 1e-3)
    assert np.abs(mt.decompress(buf, device="cpu") - v).max() <= 1e-3


def test_no_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.compress(_field((65, 65, 65)), 1e-3)
    buf = mt.compress(_field((65, 65, 65)), 1e-3, device="cpu",
                      config=mt.Config(adapt_lossless=False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mt.decompress(buf)


def test_port_imports_no_jax():
    code = ("import sys, mgard_tpu_torch, mgard_tpu_torch.api, "
            "mgard_tpu_torch.ops.transform, mgard_tpu_torch.ops.bitplane, "
            "mgard_tpu_torch.ops.stencil_kernels, "
            "mgard_tpu_torch.ops.lpk_kernels, "
            "mgard_tpu_torch.ops.bp_kernels, mgard_tpu_torch.ops.quantize, "
            "mgard_tpu_torch.models.compressor, "
            "mgard_tpu_torch.io.carry, mgard_tpu_torch.io.mgard_compat, "
            "mgard_tpu_torch.io.mdrx_compat, mgard_tpu_torch.io.protowire, "
            "mgard_tpu_torch.models.zfp, mgard_tpu_torch.models.zfp_stream, "
            "chip_smoke; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'mgard_tpu' "
            "or m.startswith('mgard_tpu.') or m == 'zstandard']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_port_sources_name_no_jax():
    """No import of jax or mgard_tpu anywhere in the port or chip_smoke.py,
    and no module-level import of zstandard: a zstd stage imports it
    where it runs, so that a machine without it fails there alone."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|mgard_tpu)\b", re.M)
    toplevel = re.compile(r"^(import|from)\s+zstandard\b", re.M)
    files = sorted((ROOT / "mgard_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not pattern.search(f.read_text()), f
        assert not toplevel.search(f.read_text()), f
