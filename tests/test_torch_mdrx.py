"""The port's MDR-X reader (``mgard_tpu_torch/io/mdrx_compat.py``) held
against ``mgard_tpu``'s on the CPU, on directories that
``tests/mdrx_fixture.py`` writes in the `mdr-x` layout: the same metadata, the same
plane counts, and reconstructions that agree within 1e-12 relative at
every tolerance and on explicit plane counts.  Inputs are made from
numpy seeds."""

import math

import numpy as np
import pytest
import torch

from mdrx_fixture import write_mdrx

from mgard_tpu.io import mdrx_compat as jmx
from mgard_tpu_torch.io import mdrx_compat as pmx
from mgard_tpu_torch.io import mgard_compat as pmc

RTOL = 1e-12


def _field(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = [np.linspace(0.0, 1.0, n) for n in shape]
    f = np.ones(())
    for d, xx in enumerate(x):
        f = f[..., None] * np.sin(3 * xx + d)
    return (f + 1e-3 * rng.standard_normal(shape)).astype(dtype)


@pytest.fixture(scope="module", params=[(33, 33, 33), (17, 65), (257,)])
def directory(request, tmp_path_factory):
    shape = request.param
    v = _field(shape, seed=len(shape))
    d = tmp_path_factory.mktemp("mdrx")
    fine = write_mdrx(d, v, device="cpu")
    return d, v, fine


def test_metadata_equal(directory):
    d, v, _ = directory
    ours, theirs = pmx.read_mdrx_metadata(d), jmx.read_mdrx_metadata(d)
    assert ours.header == theirs.header
    (lp,), (lj,) = ours.subdomains, theirs.subdomains
    assert sum(lv.num_elems for lv in lp) == v.size
    for a, b in zip(lp, lj):
        assert (a.error_bound, a.num_elems, a.exp) == \
            (b.error_bound, b.num_elems, b.exp)
        assert np.array_equal(a.sizes, b.sizes)
        assert np.array_equal(a.squared_errors, b.squared_errors)
        # the squared error after each plane never grows
        assert np.all(np.diff(a.squared_errors) <= 0)


def test_full_planes_match_written_coefficients(directory):
    """All planes back: the float64 recompose of the coefficients that
    the planes represent, within RTOL, and the field within the 32-plane
    truncation."""
    d, v, fine = directory
    hier, _ = pmc._x_hierarchy(v.shape)
    ref = pmc._x_recompose(hier, torch.from_numpy(fine)).numpy()
    out = pmx.mdrx_reconstruct(d, device="cpu")
    assert out.dtype == np.float64
    assert np.abs(out - ref).max() <= RTOL * np.abs(ref).max()
    assert np.abs(out - v).max() <= 1e-7


@pytest.mark.parametrize("tol", [None, 1e-1, 1e-2, 1e-3, 1e-5])
def test_readers_agree_at_tolerance(directory, tol):
    d, v, _ = directory
    ours = pmx.mdrx_reconstruct(d, tol=tol, device="cpu")
    theirs = jmx.mdrx_reconstruct(d, tol=tol)
    assert np.abs(ours - theirs).max() <= RTOL * np.abs(theirs).max()
    if tol is not None:
        assert np.abs(ours - v).max() <= tol


def test_readers_agree_on_plane_counts(directory):
    d, v, _ = directory
    L = len(pmx.read_mdrx_metadata(d).subdomains[0])
    errs = []
    for k in (0, 4, 8, 16, 32):
        ours = pmx.mdrx_reconstruct(d, num_bitplanes=[k] * L, device="cpu")
        theirs = jmx.mdrx_reconstruct(d, num_bitplanes=[k] * L)
        assert np.abs(ours - theirs).max() <= RTOL * max(
            np.abs(theirs).max(), 1e-300)
        errs.append(float(np.abs(ours - v).max()))
    assert errs == sorted(errs, reverse=True) and errs[-1] < errs[1]
    with pytest.raises(ValueError, match="one plane count"):
        pmx.mdrx_reconstruct(d, num_bitplanes=[4], device="cpu")


def test_plane_counts_rise_as_the_tolerance_tightens(directory):
    d, _, _ = directory
    levels = pmx.read_mdrx_metadata(d).subdomains[0]
    B = len(levels[0].sizes)
    prev = [0] * len(levels)
    for tol in (1e-1, 1e-2, 1e-3, 1e-4, 1e-6):
        counts = pmx._plane_counts(levels, B, tol, None)
        assert counts == jmx._plane_counts(levels, B, tol, None)
        assert all(a >= b for a, b in zip(counts, prev))
        prev = counts


def test_float32_dataset_agrees():
    """A float32 dataset: the readers agree to the float32 rounding of
    their float64 recompositions."""
    import tempfile
    v = _field((33, 33, 33), seed=7, dtype=np.float32)
    with tempfile.TemporaryDirectory() as d:
        write_mdrx(d, v, device="cpu")
        ours = pmx.mdrx_reconstruct(d, tol=1e-3, device="cpu")
        theirs = jmx.mdrx_reconstruct(d, tol=1e-3)
    assert ours.dtype == theirs.dtype == np.float32
    assert np.abs(ours.astype(np.float64) - theirs).max() <= \
        2.0 ** -23 * np.abs(theirs).max()
    assert np.abs(ours.astype(np.float64) - v).max() <= 1e-3


def test_subdomain_count_mismatch_raises(tmp_path):
    v = _field((17, 17), seed=2)
    write_mdrx(tmp_path, v, device="cpu")
    header, payload = pmc.read_container((tmp_path / "header").read_bytes())
    header["domain_decomposition"] = {"method": 1,
                                      "decomposition_dimension": 0,
                                      "decomposition_size": 9}
    (tmp_path / "header").write_bytes(pmc.write_container(
        header, payload, little_endian=True))
    with pytest.raises(ValueError, match="subdomains"):
        pmx.mdrx_reconstruct(tmp_path, device="cpu")


def test_frexp_exponent_of_each_level(directory):
    d, _, _ = directory
    for lv in pmx.read_mdrx_metadata(d).subdomains[0]:
        assert lv.exp == math.frexp(lv.error_bound)[1]
