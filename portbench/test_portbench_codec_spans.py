"""The readers of the flat route's spans and of the codec span on
synthetic traces: ``bitplane_ms.*`` and ``bitplane_paced_ms.*`` (inside
``mgard.bitplane``), ``quantize_ms.compress``, ``dequantize_ms.decompress``,
``decompose_ms.compress`` and ``recompose_ms.decompress``; a trace
without those spans (an older program, or the segmented route's
quantize) reads nothing."""

import pytest

from portbench import harness
from portbench.test_portbench_spans import ROOT, _trace
from portbench.test_portbench_trace import GEMM, TORCH, ev

NEW = ("bitplane_ms.compress", "bitplane_ms.decompress",
       "bitplane_paced_ms.compress", "bitplane_paced_ms.decompress",
       "quantize_ms.compress", "dequantize_ms.decompress",
       "decompose_ms.compress", "recompose_ms.decompress")
# each half's spans: the whole call's, the transform's, the scaling's
STAGES = {"compress": ("mgard.encode", "mgard.decompose", "mgard.quantize"),
          "decompress": ("mgard.decode", "mgard.recompose",
                         "mgard.dequantize")}


def call_events(half, shift=0.0, codec_first=False):
    """Two calls in a 200 us range, device times moved by ``shift``.  In
    each call (base 0 or 100): the call's span 10-80; the transform's
    span 12-30 launches a GEMM (cuLaunchKernel, at 14; device 15-25) and
    a PyTorch kernel (20; 25-28); the quantize's span 30-40 one kernel
    (32; 33-37); the codec's span 40-75 two kernels (42; 44-50, and 60;
    62-70: the device idle 12 us between them); the harness's
    synchronize 80-95.  With ``codec_first`` (the decompress's order) the
    codec runs first, then the dequantize and the transform, at the same
    times."""
    call, transform, scale = STAGES[half]
    first, last = (("mgard.bitplane", transform) if codec_first
                   else (transform, "mgard.bitplane"))
    stages = [(first, 12, 18), (scale, 30, 10), (last, 40, 35)]
    evs = [ev("user_annotation", f"portbench.{half}", 0, 200)]
    for base in (0, 100):
        evs += [ev("user_annotation", call, base + 10, 70)]
        evs += [ev("user_annotation", n, base + a, d) for n, a, d in stages]
        evs += [
            ev("cuda_driver", "cuLaunchKernel", base + 14, 2),
            ev("cuda_runtime", "cudaLaunchKernel", base + 20, 2),
            ev("cuda_runtime", "cudaLaunchKernel", base + 32, 2),
            ev("cuda_runtime", "cudaLaunchKernel", base + 42, 2),
            ev("cuda_runtime", "cudaLaunchKernel", base + 60, 2),
            ev("cuda_runtime", "cudaDeviceSynchronize", base + 80, 15),
            ev("kernel", GEMM, base + 15 + shift, 10),
            ev("kernel", TORCH, base + 25 + shift, 3),
            ev("kernel", TORCH, base + 33 + shift, 4),
            ev("kernel", TORCH, base + 44 + shift, 6),
            ev("kernel", TORCH, base + 62 + shift, 8),
        ]
    return evs


def _read(name, evs, half):
    return harness.Bench(ROOT).reader(name)(_trace(evs, half))


@pytest.mark.parametrize("shift", [0.0, -20.0])
def test_compress_stages(shift):
    evs = call_events("compress", shift)
    assert _read("decompose_ms.compress", evs, "compress") \
        == pytest.approx((10 + 3) / 1e3)
    assert _read("quantize_ms.compress", evs, "compress") \
        == pytest.approx(4 / 1e3)
    assert _read("bitplane_ms.compress", evs, "compress") \
        == pytest.approx((6 + 8) / 1e3)
    assert _read("bitplane_paced_ms.compress", evs, "compress") \
        == pytest.approx(12 / 1e3)


@pytest.mark.parametrize("shift", [0.0, 7.5])
def test_decompress_stages(shift):
    """The codec first (its span 12-30: the GEMM's and the PyTorch
    kernel's launches, no idle between them), then the dequantize and
    the recompose (40-75, with the 12 us gap)."""
    evs = call_events("decompress", shift, codec_first=True)
    assert _read("bitplane_ms.decompress", evs, "decompress") \
        == pytest.approx((10 + 3) / 1e3)
    assert _read("bitplane_paced_ms.decompress", evs, "decompress") \
        == pytest.approx(0.0)
    assert _read("dequantize_ms.decompress", evs, "decompress") \
        == pytest.approx(4 / 1e3)
    assert _read("recompose_ms.decompress", evs, "decompress") \
        == pytest.approx((6 + 8) / 1e3)


def test_each_reader_reads_its_own_half():
    """A compress reader on a decompress trace, and the reverse, reads
    nothing."""
    for name in NEW:
        half = name.split(".")[1]
        other = "compress" if half == "decompress" else "decompress"
        evs = call_events(other, codec_first=other == "decompress")
        assert _read(name, evs, other) is None, name


def test_without_the_spans_nothing_is_read():
    """A program without the new spans (the parent) reads nothing; the
    segmented route, which has ``mgard.bitplane`` but no quantize span,
    reads its codec and no quantize."""
    for half in ("compress", "decompress"):
        plain = [e for e in call_events(half)
                 if not e["name"].startswith("mgard.")]
        for name in NEW:
            if name.endswith(half):
                assert _read(name, plain, half) is None, name
    segmented = [e for e in call_events("compress")
                 if e["name"] != "mgard.quantize"]
    assert _read("quantize_ms.compress", segmented, "compress") is None
    assert _read("bitplane_ms.compress", segmented, "compress") \
        == pytest.approx((6 + 8) / 1e3)


def test_the_new_metrics_are_in_the_benchmark():
    bench = harness.Bench(ROOT)
    names = {m["name"]: m for m in bench.spec["per_layer"]}
    for name in NEW:
        m = names[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert "miranda.linf-1e-8" in m["workloads"]
        assert (name.startswith("bitplane")) \
            == ("nyx-512.tight" in m["workloads"])
