"""The readers of the program's spans (``spans.py``) on synthetic events:
span host times; operations paired with their launches by order and
attributed to the span the launch lies in, through cudaLaunchKernel and
cuLaunchKernel, with the device's clock off the host's and a record
lost; the device's idle time between operations of one span; a trace
without the spans reads nothing, and the spans change no reading of the
metrics that read kernels by name."""

import json
from pathlib import Path

import pytest

from portbench import harness, spans, trace
from portbench.test_portbench_trace import GEMM, K2, K5, ev, events

ROOT = Path(__file__).resolve().parent.parent
NEW = ("enqueue_ms", "paced_ms", "correction_ms")


def _trace(evs, half="decompress", calls=2):
    bench = harness.Bench(ROOT)
    h = trace.Half(evs, half, calls, bench.kernel_map())
    return trace.Trace({half: h}, (512, 512, 512), 4, bench.kernel,
                       3.35e12)


def decode_events(shift=0.0):
    """Two decodes in a 200 us range, device times moved by ``shift``
    against the host's.  Call 1 (0-90): the program's span 10-70, a
    correction inside it 20-40 that launches a GEMM (through
    cuLaunchKernel, as cuBLAS does) and K5, then K2; the harness's
    synchronize 70-90, after which the device has run all that call 1
    queued.  Call 2 (100-190) the same, its span 110-170 and correction
    120-140, with a copy launched inside the correction and run after
    K5."""
    evs = [ev("user_annotation", "portbench.decompress", 0, 200)]
    for base in (0, 100):
        evs += [
            ev("user_annotation", "mgard.decode", base + 10, 60),
            ev("user_annotation", "mgard.correction", base + 20, 20),
            ev("cuda_driver", "cuLaunchKernel", base + 22, 2),
            ev("cuda_runtime", "cudaLaunchKernel", base + 30, 2),
            ev("cuda_runtime", "cudaLaunchKernel", base + 50, 4),
            ev("cuda_runtime", "cudaDeviceSynchronize", base + 70, 20),
            # device: GEMM 25-35, K5 36-46, idle 46-58, K2 58-72
            ev("kernel", GEMM, base + 25 + shift, 10),
            ev("kernel", K5, base + 36 + shift, 10),
            ev("kernel", K2, base + 58 + shift, 14),
        ]
    evs += [ev("cuda_runtime", "cudaMemcpyAsync", 135, 2),
            ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 147 + shift,
               5)]
    return evs


def test_span_host_ms_a_call():
    t = _trace(decode_events())
    assert spans.span_ms(t, "decompress", "mgard.decode") \
        == pytest.approx(0.060)
    assert spans.span_ms(t, "decompress", "mgard.correction") \
        == pytest.approx(0.020)
    assert spans.span_ms(t, "decompress", "mgard.encode") is None
    assert spans.span_ms(t, "compress", "mgard.decode") is None


@pytest.mark.parametrize("shift", [0.0, -20.0, 7.5])
def test_operations_follow_the_span_of_their_launch(shift):
    """The GEMM (a cuLaunchKernel), K5 and the copy of call 2 are the
    correction's; K2 is only the decode's.  Device times early or late
    against the host's change nothing: nothing compares the two."""
    t = _trace(decode_events(shift))
    kept, share = spans.pairs(t.half("decompress"))
    assert len(kept) == 7 and share == 1.0
    assert spans.launched_ms(t, "decompress", "mgard.correction") \
        == pytest.approx((10 + 10 + 10 + 10 + 5) / 1e3 / 2)
    assert spans.launched_ms(t, "decompress", "mgard.decode") \
        == pytest.approx((34 + 34 + 5) / 1e3 / 2)
    assert spans.launched_ms(t, "decompress", "mgard.bitplane") is None


@pytest.mark.parametrize("shift", [0.0, -20.0])
def test_idle_between_operations_of_one_span(shift):
    """Counted: the gaps between two operations launched inside one
    decode (1 and 12 us in call 1; 1, 1 and 6 in call 2); not the wait
    for a call's first operation, nor the one across the synchronize."""
    t = _trace(decode_events(shift))
    assert spans.paced_ms(t, "decompress", "mgard.decode") == pytest.approx(
        (1 + 12 + 1 + 1 + 6) / 1e3 / 2)
    # inside one correction: GEMM to K5 in each call, K5 to the copy
    assert spans.paced_ms(t, "decompress", "mgard.correction") \
        == pytest.approx((1 + 1 + 1) / 1e3 / 2)


def test_a_lost_record_leaves_its_stretch_out():
    """The profiler lost call 1's first record (the GEMM): the pairing
    shifts by one, call 1 has a launch without an operation and is left
    out, and call 2 (4 of the 7 launches) stands for both."""
    evs = [e for e in decode_events() if not (e["name"] == GEMM
                                              and e["ts"] < 100)]
    t = _trace(evs)
    kept, share = spans.pairs(t.half("decompress"))
    assert [op["ts"] for op, _ in kept] == [125, 136, 147, 158]
    assert share == pytest.approx(4 / 7)
    assert spans.launched_ms(t, "decompress", "mgard.correction") \
        == pytest.approx((10 + 10 + 5) / (4 / 7) / 1e3 / 2)
    assert spans.paced_ms(t, "decompress", "mgard.decode") == pytest.approx(
        (1 + 1 + 6) / (4 / 7) / 1e3 / 2)


def test_pairs_that_do_not_fit_read_nothing():
    """A cuLaunchKernel paired with PyTorch's kernel or a copy call with a
    kernel does not fit: where every stretch holds such a pair, nothing
    is read."""
    evs = [dict(e, name="cuLaunchKernel", cat="cuda_driver")
           if e["name"] == "cudaLaunchKernel" else e
           for e in decode_events()]
    t = _trace(evs)
    assert spans.pairs(t.half("decompress")) == ([], 0.0)
    assert spans.launched_ms(t, "decompress", "mgard.correction") is None
    assert spans.paced_ms(t, "decompress", "mgard.decode") is None


def test_readers_of_a_trace_without_spans_read_nothing():
    """An older program records no spans: every new reader gives None,
    on the existing synthetic trace and on the decode's without its
    spans."""
    bench = harness.Bench(ROOT)
    plain = [e for e in decode_events() if not e["name"].startswith("mgard.")]
    for evs, half in ((events(), "compress"), (plain, "decompress")):
        t = _trace(evs, half)
        for m in json.loads((ROOT / "BENCHMARK.json").read_text())[
                "per_layer"]:
            if m["name"].split(".")[0] in NEW:
                assert bench.reader(m["name"])(t) is None, m["name"]


def test_spans_change_no_existing_reading():
    """The existing synthetic compress with the program's spans laid over
    it: every existing reader reads what it read without them."""
    bench = harness.Bench(ROOT)
    spanned = events() + [ev("user_annotation", "mgard.encode", 1000, 80),
                          ev("user_annotation", "mgard.correction", 1005,
                             20)]
    before, after = _trace(events(), "compress"), _trace(spanned, "compress")
    for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]:
        if m["name"].split(".")[0] not in NEW:
            read = bench.reader(m["name"])
            assert read(before) == read(after), m["name"]
    assert spans.span_ms(after, "compress", "mgard.encode") \
        == pytest.approx(0.040)
