"""mgard_tpu_torch's spans and counters, on the CPU: the span tree that
one ``encode_device`` and one ``decode_device`` record under
``torch.profiler``, the spans' silence with the profiler off (the
outputs the same bits), their host times at ``log.TIME``, and the
counters of the table bytes that ``ops/tridiag._upload`` queues and of
the calls that ran on resident tables."""

import json
import math

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

import mgard_tpu_torch as mt
from mgard_tpu_torch import api
from mgard_tpu_torch.config import Config
from mgard_tpu_torch.ops import tridiag as ttd
from mgard_tpu_torch.utils import log

# a 3-D field on the dense matrices at every level, and a 1-D one whose
# finest level takes the per-dim form (more than 4096 nodes)
SHAPES = [(17, 17, 17), (5000,)]
TOL = 1e-3


def _field(shape):
    rng = np.random.default_rng(sum(shape))
    grids = np.meshgrid(*[np.linspace(0, 1, n) for n in shape],
                        indexing="ij")
    v = sum(np.sin(3 * g + i) for i, g in enumerate(grids))
    return torch.from_numpy(
        (v + 1e-3 * rng.standard_normal(shape)).astype(np.float32))


def _compressor(shape):
    # adapt_lossless off: the segmented codec that the benchmark's cells
    # run (small fields otherwise take the per-group one)
    return mt.get_compressor(shape, np.float32, math.inf,
                             config=Config(adapt_lossless=False),
                             device="cpu")


def _round_trip(comp, v):
    exponents, words, count, status = comp.encode_device(v, TOL)
    assert int(status) == 0
    out = comp.decode_device(exponents, words[:int(count)], TOL)
    return exponents, words[:int(count)], out


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _spans(prof, tmp_path):
    """The ``mgard.*`` ranges of a profile: (name, start, end) by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    events = raw["traceEvents"] if isinstance(raw, dict) else raw
    return sorted((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"
                  and e["name"].startswith("mgard."))


def _inside(child, parent):
    return parent[1] <= child[1] and child[2] <= parent[2]


def _one(spans, name, within):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, found)
    assert _inside(found[0], within), (name, within)
    return found[0]


def _check_tree(spans, top, transform, L):
    """One ``top`` span around it all; one transform span and one
    ``mgard.bitplane`` beside it; a span for each level inside the
    transform's, and one ``mgard.correction`` inside each level."""
    assert sum(s[0] == top for s in spans) == 1
    root = next(s for s in spans if s[0] == top)
    assert all(_inside(s, root) for s in spans)
    tr = _one(spans, transform, root)
    bp = _one(spans, "mgard.bitplane", root)
    assert not _inside(bp, tr) and not _inside(tr, bp)
    corrections = [s for s in spans if s[0] == "mgard.correction"]
    assert len(corrections) == L
    for l in range(1, L + 1):
        level = _one(spans, f"mgard.level.{l}", tr)
        assert sum(_inside(c, level) for c in corrections) == 1, l
    names = {top, transform, "mgard.bitplane", "mgard.correction"} | {
        f"mgard.level.{l}" for l in range(1, L + 1)}
    assert {s[0] for s in spans} == names


@pytest.mark.parametrize("shape", SHAPES)
def test_spans_of_an_encode_and_a_decode(shape, tmp_path):
    comp = _compressor(shape)
    assert comp._codec(comp.lossless) == "segmented"
    v = _field(shape)
    _round_trip(comp, v)                    # tables and caches made
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        exponents, words, _, _ = comp.encode_device(v, TOL)
    enc = _spans(prof, tmp_path)
    _check_tree(enc, "mgard.encode", "mgard.decompose", comp.hier.L)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        comp.decode_device(exponents, words, TOL)
    dec = _spans(prof, tmp_path)
    _check_tree(dec, "mgard.decode", "mgard.recompose", comp.hier.L)
    # the codec comes after the decompose and before the recompose
    e, d = {s[0]: s for s in enc}, {s[0]: s for s in dec}
    assert e["mgard.bitplane"][1] >= e["mgard.decompose"][2]
    assert d["mgard.bitplane"][2] <= d["mgard.recompose"][1]


@pytest.mark.parametrize("shape", SHAPES)
def test_profiler_off_records_nothing_and_changes_no_bit(shape,
                                                         monkeypatch):
    comp = _compressor(shape)
    v = _field(shape)
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _round_trip(comp, v)

    def refuse(*args, **kw):
        raise AssertionError("record_function entered with the profiler "
                             "off")
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(log, "level", log.ERR | log.WARN)
    assert not autograd_profiler._is_profiler_enabled
    assert log.span("mgard.encode") is log.span("mgard.level.3")
    plain = _round_trip(comp, v)
    for a, b in zip(traced, plain):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


def test_spans_print_their_host_ms_at_time(capsys, monkeypatch):
    """At ``log.TIME`` each span is a Timer that reports its ms, with no
    profiler running; ``record_function`` is not entered."""
    def refuse(*args, **kw):
        raise AssertionError("record_function entered with the profiler "
                             "off")
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    monkeypatch.setattr(log, "level", log.TIME)
    comp = _compressor((17, 17, 17))
    capsys.readouterr()
    _round_trip(comp, _field((17, 17, 17)))
    err = capsys.readouterr().err
    for name in ("mgard.encode", "mgard.decompose", "mgard.level.1",
                 "mgard.correction", "mgard.bitplane", "mgard.decode",
                 "mgard.recompose"):
        assert f"[mgard-tpu time] {name}: " in err, name
    assert isinstance(log.span("x", 8), log.Timer)


@pytest.mark.parametrize("admitted", [True, False],
                         ids=["resident", "not_admitted"])
def test_table_bytes_counter(monkeypatch, admitted):
    """``tables.bytes`` adds the bytes of each host table ``_upload`` is
    handed, those of a whole encode and decode with a card faked (the
    CPU takes the card's table path), and resets.  Where the hierarchy's
    tables are kept on the card, a second round trip copies none and
    ``tables.resident`` counts each encode and decode; where they are not
    admitted (the card's free memory read as 1 KiB), every call copies
    its tables again and nothing is counted as resident."""
    log.reset_counts()
    assert log.counts() == {}
    ttd._upload(torch.ones(10, dtype=torch.float32), "cpu")
    ttd._upload(torch.ones(3, dtype=torch.float64), "cpu")
    assert log.counts() == {"tables.bytes": 64}
    log.count("other")
    snap = log.counts()
    assert snap == {"tables.bytes": 64, "other": 1}
    log.count("other", 2)
    assert snap["other"] == 1           # a snapshot, not a view
    log.reset_counts()
    assert log.counts() == {}

    mt.release_cache()                  # each case decides afresh
    handed = []
    upload = ttd._upload
    monkeypatch.setattr(ttd, "_on_card", lambda device: True)
    monkeypatch.setattr(ttd, "_upload", lambda host, device: handed.append(
        host.numel() * host.element_size()) or upload(host, device))
    if not admitted:
        monkeypatch.setattr(api, "_device_memory_budget",
                            lambda device: 1 << 10)
    comp = _compressor((5000,))
    v = _field((5000,))
    _round_trip(comp, v)
    once = sum(handed)
    assert once and log.counts()["tables.bytes"] == once
    _round_trip(comp, v)
    if admitted:
        # the tables stay on the card: the second round trip copies none
        assert log.counts() == {"tables.bytes": once, "tables.resident": 4}
        assert ttd.resident_bytes() == once
    else:
        # every call copies its tables again: a second round trip doubles
        assert log.counts() == {"tables.bytes": 2 * once}
        assert sum(handed) == 2 * once and ttd.resident_bytes() == 0
    log.reset_counts()
    assert log.counts() == {}
    del comp
    mt.release_cache()
    assert ttd.resident_bytes() == 0
