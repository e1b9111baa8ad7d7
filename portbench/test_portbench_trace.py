"""The trace reducer on synthetic events: overlapping kernels and copies
for the idle share, per-layer sums, unmatched names, the rooflines."""

import json
from pathlib import Path

import pytest

from portbench import harness, trace

ROOT = Path(__file__).resolve().parent.parent
K5 = "(anonymous namespace)::gpk_detail_kernel(float const*, float*)"
K2 = "(anonymous namespace)::bp_quant_max_segments_kernel(int)"
S1 = "void mgard_s1::solve_runs<float>(float const*)"
GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize_cublas"
TORCH = "void at::native::reduce_kernel<512, 1>(int)"


def ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}


def events():
    """One compress range of 100 us over two calls: kernels and copies
    that overlap, a gap under a synchronize, and events outside the
    range."""
    return [
        ev("user_annotation", "portbench.compress", 1000, 100),
        ev("kernel", K5, 1000, 20),
        ev("kernel", GEMM, 1010, 20),           # overlaps K5: 1000-1030
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 1040, 10),
        ev("kernel", K2, 1045, 15),             # 1040-1060
        ev("kernel", TORCH, 1070, 5),           # 1070-1075
        ev("gpu_memset", "Memset (Device)", 1090, 5),
        ev("cuda_runtime", "cudaStreamSynchronize", 1060, 12),
        ev("cuda_runtime", "cudaLaunchKernel", 1076, 2),
        ev("cpu_op", "aten::copy_", 1075, 20),
        ev("kernel", K5, 2000, 50),             # outside the range
    ]


def test_idle_share_sums_and_names():
    kmap = harness.Bench(ROOT).kernel_map()
    half = trace.Half(events(), "compress", 2, kmap)
    t = trace.Trace({"compress": half}, (512, 512, 512), 4,
                    harness.Bench(ROOT).kernel, 3.35e12)
    # busy: 1000-1030, 1040-1060, 1070-1075, 1090-1095 = 60 of 100 us
    assert half.busy_us() == 60.0
    assert t.idle_pct("compress") == pytest.approx(40.0)
    assert t.idle_pct("decompress") is None
    assert t.launches("compress") == 2.0
    assert t.layer_ms("compress", ("transform", "cublas")) \
        == pytest.approx(0.020)
    assert t.layer_ms("compress", ("codec",)) == pytest.approx(0.0075)
    assert t.layer_ms("compress", ("torch",)) == pytest.approx(0.0025)
    assert t.layer_ms("compress", ("s1",)) is None
    assert t.copy_ms("compress", "HtoD") == pytest.approx(0.005)
    assert t.unmapped() == {"reduce_kernel": 1}
    # 1030-1040 under no host event, 1060-1070 under the synchronize,
    # 1075-1090 under the copy (the launch is shorter but not under the
    # middle), 1095-1100 under no host event again
    assert half.gaps() == [("host", 10.0), ("cudaStreamSynchronize", 10.0),
                           ("aten::copy_", 15.0), ("host", 5.0)]
    busy, window = t.device_seconds()
    assert (busy, window) == pytest.approx((60e-6, 100e-6))
    b = t.breakdown()
    assert b["device_ops"][0][0] == "gpk_detail_kernel"
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_roofline_of_a_kernel():
    """K5 once a call at 512^3: 1073741824 bytes, 0.3205 ms at the peak;
    traced at 0.641 ms a call it reads 50%."""
    bench = harness.Bench(ROOT)
    evs = [ev("user_annotation", "portbench.compress", 0, 5000),
           ev("kernel", K5, 0, 641.0), ev("kernel", K5, 1000, 641.0)]
    half = trace.Half(evs, "compress", 2, bench.kernel_map())
    t = trace.Trace({"compress": half}, (512, 512, 512), 4, bench.kernel,
                    3.35e12)
    assert t.roofline_pct("compress", "K5") == pytest.approx(
        100 * 1073741824 / 3.35e12 * 1e6 / 641.0)
    # twice a call is not the launch the byte count knows: no reading
    half.calls = 1
    assert t.roofline_pct("compress", "K5") is None
    assert t.roofline_pct("compress", "S1") is None
    t.peak_bytes_per_s = None
    assert t.roofline_pct("compress", "K5") is None


def test_readers_find_nothing_and_say_so():
    bench = harness.Bench(ROOT)
    evs = [ev("user_annotation", "portbench.compress", 0, 10)]
    half = trace.Half(evs, "compress", 1, bench.kernel_map())
    t = trace.Trace({"compress": half}, (512,), 4, bench.kernel, 3.35e12)
    for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]:
        assert bench.reader(m["name"])(t) is None, m["name"]


def test_a_range_must_be_there_once():
    kmap = harness.Bench(ROOT).kernel_map()
    with pytest.raises(ValueError):
        trace.Half([ev("kernel", K5, 0, 1)], "compress", 1, kmap)


def test_chrome_trace_is_read(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": K5, "ts": 5.5, "dur": 2},
        {"ph": "i", "cat": "x", "name": "mark", "ts": 1},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 1}]}))
    assert trace.load_chrome(path) == [
        ev("kernel", K5, 5.5, 2), ev("cpu_op", "aten::add", 1, 0)]
