"""Whole runs through the harness: on the CPU at a tiny size with the
timed path broken underneath or the control put in the program's place
(``correct`` must come out false), the same control on the card at each
cell's own size, and the refusals of run.py."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, reference
from portbench.test_portbench_spec import tiny_root

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 17


@pytest.fixture
def bench(tmp_path):
    return harness.Bench(tiny_root(tmp_path, shape=(9, 9, 9), nfields=2))


def _run(bench, trace=False):
    return harness.run(bench, "tiny.linf", SEED, 0.05, trace, device="cpu")


def test_sound_run_is_correct(bench):
    r = _run(bench)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    assert list(r)[-1] == "checks"
    assert r["checks"]["max_err"]["value"] < 1e-3
    assert r["checks"]["container_max_err"]["value"] < 1e-3
    assert set(r["metrics"]) == {"compress_GBps", "decompress_GBps",
                                 "compress_p95_ms", "ratio", "setup_s"}
    assert r["metrics"]["ratio"]["value"] > 1


def test_traced_run_is_correct_and_reads_the_trace(bench):
    r = _run(bench, trace=True)
    assert r["correct"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r


def _compressor():
    from mgard_tpu_torch.models.compressor import Compressor
    return Compressor


def fault_stale(monkeypatch):
    """A decode that returns its state unchanged: its first output,
    whatever stream it is given."""
    C = _compressor()
    orig, first = C.decode_device, []

    def stale(self, *args, **kw):
        if not first:
            first.append(orig(self, *args, **kw))
        return first[0]
    monkeypatch.setattr(C, "decode_device", stale)


def fault_half(monkeypatch):
    """A decode that leaves half of the field out."""
    C = _compressor()
    orig = C.decode_device

    def half(self, *args, **kw):
        out = orig(self, *args, **kw).clone()
        out.view(-1)[out.numel() // 2:] = 0
        return out
    monkeypatch.setattr(C, "decode_device", half)


def fault_altered(monkeypatch):
    """A decode that alters one value where it is produced."""
    C = _compressor()
    orig = C.decode_device

    def altered(self, *args, **kw):
        out = orig(self, *args, **kw).clone()
        out.view(-1)[out.numel() // 3] += 0.01
        return out
    monkeypatch.setattr(C, "decode_device", altered)


def fault_stale_stream(monkeypatch):
    """An encode that returns its state unchanged: the first stream it
    made, whatever field it is given."""
    C = _compressor()
    orig, first = C.encode_device, []

    def stale(self, *args, **kw):
        if not first:
            first.append(orig(self, *args, **kw))
        return first[0]
    monkeypatch.setattr(C, "encode_device", stale)


def fault_status(monkeypatch):
    """An encode that reports a failure on a sound field."""
    C = _compressor()
    orig = C.encode_device

    def failing(self, *args, **kw):
        e, w, count, status = orig(self, *args, **kw)
        return e, w, count, torch.ones_like(status)
    monkeypatch.setattr(C, "encode_device", failing)


def fault_control(monkeypatch):
    """The control in the program's place: each decode's array kept in the
    precision below the configuration's (``reference.control_output``)."""
    C = _compressor()
    orig = C.decode_device

    def control(self, *args, **kw):
        return reference.control_output(orig(self, *args, **kw))
    monkeypatch.setattr(C, "decode_device", control)


def fault_truncated_section(monkeypatch):
    """A container whose word section lost its second half where the
    sections are made: the stored bytes shrink and the ratio rises."""
    C = _compressor()
    orig = C.sections_from_outputs

    def truncated(self, *args, **kw):
        exp_bytes, word_bytes = orig(self, *args, **kw)
        return [exp_bytes, word_bytes[:len(word_bytes) // 8 * 4]]
    monkeypatch.setattr(C, "sections_from_outputs", truncated)


@pytest.mark.parametrize("fault", [fault_stale, fault_half, fault_altered,
                                   fault_stale_stream, fault_status,
                                   fault_control, fault_truncated_section])
def test_broken_timed_path_is_not_correct(bench, monkeypatch, fault):
    """A fault shows as correct false, or as a run that raises and so
    prints no result."""
    fault(monkeypatch)
    try:
        r = _run(bench)
    except (OverflowError, ValueError, RuntimeError):
        return
    assert r["correct"] is False and r["failed"] > 0, fault.__name__


def test_control_fails_where_the_program_passes(bench, monkeypatch):
    """The program's readings on two seeds lie far under the limit; the
    control's, through the same run, over it."""
    limit = bench.traffic("tiny")["abs_tol"]
    program = [harness.run(bench, "tiny.linf", seed, 0.05, False,
                           device="cpu")["checks"] for seed in (1, SEED)]
    assert max(c[k]["value"] for c in program
               for k in ("max_err", "container_max_err")) < limit / 3
    fault_control(monkeypatch)
    for seed in (2, 3, 2**33):
        r = harness.run(bench, "tiny.linf", seed, 0.05, False, device="cpu")
        assert r["correct"] is False
        assert r["checks"]["max_err"]["value"] > limit


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal on a machine without CUDA")


def test_no_card_no_result(no_card):
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nyx-512.linf",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.card
def test_bare_checkout_no_result(card, tmp_path):
    """Only BENCHMARK.json and portbench/: no program, so no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nyx-512.linf",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["nyx-512.linf", "hacc-1d.linf"])
def test_control_at_the_cells_size(card, monkeypatch, cell):
    """Each cell at its own size, with the control in the program's place
    on three seeds: every run comes out not correct, its max_err over the
    limit.  Prints the readings, one JSON line a cell."""
    knobs = harness.pin_knobs()
    bench = harness.Bench(ROOT)
    limit = bench.traffic(bench.workload(cell)["traffic"])["abs_tol"]
    fault_control(monkeypatch)
    readings = {}
    try:
        for seed in (7100000001, 7100000002, 7100000003):
            r = harness.run(bench, cell, seed, 1.0, False, device="cuda")
            readings[seed] = r["checks"]["max_err"]["value"]
            assert r["correct"] is False and readings[seed] > limit
    finally:
        knobs.cleanup()
        print(json.dumps({"cell": cell, "control_max_err": readings,
                          "limit": limit}))
