"""The yardstick: fields from the seed, the reference's arithmetic, the
kernels' byte counts, the level rule they read, and the kernel-name map
against the program's CUDA sources."""

import json
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import grid, harness, reference, trace

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "mgard_tpu_torch" / "csrc"
PEAK = 3.35e12
CFG = {"shape": [9, 10, 11], "dtype": "float32",
       "generator": {"modes": [1, 3, 7], "phase": 0.1, "noise": 0.001}}


def test_same_seed_same_field():
    a = reference.make_field(CFG, 2**31 + 5, 2, "cpu")
    b = reference.make_field(CFG, 2**31 + 5, 2, "cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert not torch.equal(a, reference.make_field(CFG, 2**31 + 5, 3, "cpu"))
    assert not torch.equal(a, reference.make_field(CFG, 2**31 + 6, 2, "cpu"))


def test_field_is_the_smooth_modes_plus_noise():
    """Without noise the field is the three separable modes, by numpy."""
    cfg = dict(CFG, generator=dict(CFG["generator"], noise=0.0))
    got = reference.make_field(cfg, 1, 0, "cpu").double().numpy()
    want = np.zeros(CFG["shape"])
    for k in (1, 3, 7):
        term = 1.0
        for d, n in enumerate(CFG["shape"]):
            x = np.linspace(0.0, 1.0, n)
            c = np.cos(np.pi * k * x + 0.1 * k * (d + 1))
            term = term * c.reshape([n if i == d else 1 for i in range(3)])
        want += term / k
    assert np.abs(got - want).max() < 1e-5


def test_field_seeds_take_any_whole_number():
    seeds = {reference.field_seed(s, f) for s in (0, 2**31 + 11, 2**40)
             for f in range(6)}
    assert len(seeds) == 18 and all(0 <= s < 2**63 for s in seeds)


def test_max_abs_error_agrees_with_numpy(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK", 7)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((5, 6)).astype(np.float32)
    b = (a + rng.uniform(-1e-3, 1e-3, a.shape)).astype(np.float32)
    want = np.abs(b.astype(np.float64) - a.astype(np.float64)).max()
    got = reference.max_abs_error(torch.from_numpy(a), torch.from_numpy(b))
    assert got == want
    b[2, 3] = np.nan
    assert reference.max_abs_error(torch.from_numpy(a),
                                   torch.from_numpy(b)) == math.inf
    assert reference.max_abs_error(torch.from_numpy(a),
                                   torch.from_numpy(a[:4])) == math.inf


def test_control_breaks_the_bound_at_these_values():
    v = reference.make_field(CFG, 4, 0, "cpu")
    err = reference.max_abs_error(v, reference.control_output(v))
    # bfloat16 keeps 8 bits: half an ulp of values in [1, 2) is 2^-8
    assert 1e-3 < err <= 2.0 ** -8


def test_level_shapes_match_the_hierarchy():
    from mgard_tpu_torch.hierarchy import Hierarchy
    for shape in [(512,), (17, 17, 17), (9, 10, 11), (5000,), (33, 1, 7),
                  (6, 129)]:
        assert grid.level_shapes(shape) == list(Hierarchy(shape).shapes)


def test_solved_levels_are_the_solves_of_an_encode(monkeypatch):
    """Run a 1-D encode on the CPU with S1 recorded: each solve's dims and
    sizes are what the byte count of S1 counts."""
    from mgard_tpu_torch.models.compressor import get_compressor
    from mgard_tpu_torch.ops import transform, tridiag
    calls = []
    solve = tridiag.mass_solve

    def record(b, offdiag, divisors, axis):
        calls.append((b.shape[axis], b.numel()))
        return solve(b, offdiag, divisors, axis)

    monkeypatch.setattr(transform, "mass_solve", record)
    shape = (2 * grid.MATMUL_MAX_N + 3,)
    comp = get_compressor(shape, np.float32, device="cpu")
    comp.encode_device(torch.linspace(0, 1, shape[0]), 1e-3)
    want = [(n, grid.numel(c)) for _, c in grid.solved_levels(shape)
            for n in c if n > 1]
    assert sorted(calls) == sorted(want) and len(want) == 3


def _bound_ms(nbytes):
    return nbytes / PEAK * 1e3


def test_byte_counts_reproduce_the_kernel_table():
    bench = harness.Bench(ROOT)
    k5 = bench.kernel("K5").bytes_per_call((512, 512, 512), 4, 1)
    k6 = bench.kernel("K6").bytes_per_call((512, 512, 512), 4, 1)
    assert round(_bound_ms(k5), 4) == 0.3205
    assert round(_bound_ms(k6), 4) == 0.3408
    s1 = bench.kernel("S1")
    n = 2**28 + 1
    assert round(_bound_ms(s1.solve_bytes(n, n, 4)), 4) == 1.2821
    # the series' compress: one solve a level from 2^11 + 1 to 2^28 + 1
    series = s1.bytes_per_call((280953867,), 4, 0)
    assert series == sum(s1.solve_bytes(2**k + 1, 2**k + 1, 4)
                         for k in range(11, 29))
    assert bench.kernel("K5").bytes_per_call((512, 512, 512), 4, 2) is None
    assert s1.bytes_per_call((512, 512, 512), 4, 0) is None


def _csrc_symbols():
    found = {}
    for path in sorted(CSRC.glob("*.cu*")):
        text = path.read_text()
        for m in re.finditer(r"__global__\s+(?:void\s+)?(?:__launch_bounds__"
                             r"\([^)]*\)\s+)?(?:void\s+)?(\w+)\s*\(", text):
            found[m.group(1)] = path.name
    return found


def test_kernel_map_names_every_symbol_of_the_sources():
    kmap = harness.Bench(ROOT).kernel_map()
    symbols = _csrc_symbols()
    assert symbols, "no __global__ found under csrc"
    assert set(kmap.symbols) == set(symbols)
    for sym, entry in kmap.symbols.items():
        assert entry["file"] == symbols[sym], sym
    kernels = {e["kernel"] for e in kmap.symbols.values()}
    assert kernels == {f"K{i}" for i in range(1, 17)} | {"S1"}


def test_kernel_names_as_the_profiler_gives_them():
    kmap = harness.Bench(ROOT).kernel_map()
    cases = {
        "(anonymous namespace)::gpk_detail_kernel(float const*, float*, "
        "(anonymous namespace)::DimTable, (anonymous namespace)::DimTable,"
        " (anonymous namespace)::DimTable, int)": ("K5", "transform"),
        "void mgard_s1::solve_runs<float>(float const*, float const*, "
        "float const*, float*, mgard_s1::Bounds<float>, mgard_s1::Geo, "
        "int*)": ("S1", "s1"),
        "void mgard_s1::fix_bounds<float, true>(float const*)": ("S1", "s1"),
        "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32_warpgroup"
        "size1x1x1_execute_segment_k_off_kernel__5x_cublas": (None,
                                                              "cublas"),
        "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x64_8x5_nn_align1>"
        "(cutlass_80_simt_sgemm_128x64_8x5_nn_align1::Params)": (None,
                                                                 "cublas"),
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "FillFunctor<float>, std::array<char*, 1ul> >(int, at::native::"
        "FillFunctor<float>, std::array<char*, 1ul>)": (None, "torch"),
        "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_"
        "impl_nocast<at::native::BinaryFunctor<float, float, float, at::"
        "native::binary_internal::MulFunctor<float> > >(at::TensorIterator"
        "Base&, at::native::BinaryFunctor<float, float, float, at::native::"
        "binary_internal::MulFunctor<float> > const&)::{lambda(int)#1}>("
        "int, {lambda(int)#1})": (None, "torch"),
    }
    for name, want in cases.items():
        assert kmap.classify(name) == want, name
    assert trace.symbol(next(iter(cases))) == "gpk_detail_kernel"


def test_kernel_map_files_merge_and_refuse_a_symbol_twice():
    with open(ROOT / "portbench" / "kernelmap" / "port.json") as f:
        part = json.load(f)
    with pytest.raises(ValueError):
        trace.KernelMap([part, {"symbols": {"solve_runs": {
            "kernel": "S1", "layer": "s1"}}}])
