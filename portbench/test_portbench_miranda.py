"""The cells ``miranda.linf-1e-8`` and ``nyx-512.tight`` on the CPU at a
tiny size, through the harness: a float64 configuration non-dyadic in
every dim (as Miranda's 256x384x384 is) at ABS 1e-8 and a float32 one
at ABS 1e-5 come out correct, and the control (the field kept one
precision lower) in the program's place does not."""

import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.test_portbench_run import fault_control
from portbench.test_portbench_spec import tiny_root

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 23
# non-dyadic in every dim: four levels, the top one not a doubling
SHAPE64 = (16, 24, 24)
MIRANDA = "tiny64.linf-1e-8"
TIGHT = "tiny.tight"


@pytest.fixture
def bench(tmp_path):
    """A checkout like ``tiny_root``'s, with a float64 configuration made
    from ``miranda.json`` at SHAPE64 and two cells on the new traffic
    mixes, of new files only."""
    root = tiny_root(tmp_path, shape=(9, 9, 9), nfields=2)
    with open(ROOT / "portbench" / "configs" / "miranda.json") as f:
        cfg = json.load(f)
    cfg.update(name="tiny64", shape=list(SHAPE64), fields=cfg["fields"][:2])
    (root / "portbench" / "configs" / "tiny64.json").write_text(
        json.dumps(cfg))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny64", "source": "a test",
                            "file": "portbench/configs/tiny64.json",
                            "reduced": ["shape"], "why": "a test"})
    spec["workloads"] += [
        {"name": MIRANDA, "config": "tiny64", "traffic": "linf-1e-8",
         "chips": 1, "why": "a test"},
        {"name": TIGHT, "config": "tiny", "traffic": "tight", "chips": 1,
         "why": "a test"}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root)


def _limit(bench, cell):
    return bench.traffic(bench.workload(cell)["traffic"])["abs_tol"]


def test_the_traffic_mixes():
    bench = harness.Bench(ROOT)
    assert bench.traffic("linf-1e-8")["abs_tol"] == 1e-8
    assert bench.traffic("tight")["abs_tol"] == 1e-5
    for name in ("linf-1e-8", "tight"):
        assert bench.traffic(name)["s"] == "inf"
    cfg = bench.config("miranda")
    assert cfg["shape"] == [256, 384, 384] and cfg["dtype"] == "float64"
    assert len(cfg["fields"]) == 7
    assert cfg["generator"] == bench.config("nyx-512")["generator"]


@pytest.mark.parametrize("cell", [MIRANDA, TIGHT])
def test_sound_run_is_correct(bench, cell):
    limit = _limit(bench, cell)
    r = harness.run(bench, cell, SEED, 0.05, False, device="cpu")
    checks = r["checks"]
    assert r["correct"] and r["failed"] == 0, checks
    assert checks["max_err"]["value"] <= limit
    assert checks["container_max_err"]["value"] <= limit
    assert checks["bad_status"]["value"] == 0
    assert checks["unchecked_fields"]["value"] == 0
    assert set(r["metrics"]) == {"compress_GBps", "decompress_GBps",
                                 "ratio", "setup_s"}


def test_float64_cell_runs_the_wide_codec(bench, monkeypatch):
    """The float64 cell's window drives the flat route's wide codec, and
    its traced run is correct."""
    from mgard_tpu_torch.ops import bitplane
    calls = []
    encode64 = bitplane.encode64
    monkeypatch.setattr(bitplane, "encode64",
                        lambda *a, **kw: calls.append(1) or encode64(*a, **kw))
    r = harness.run(bench, MIRANDA, SEED, 0.05, True, device="cpu")
    assert r["correct"] and calls


@pytest.mark.parametrize("cell", [MIRANDA, TIGHT])
def test_control_is_not_correct(bench, monkeypatch, cell):
    """The control in the program's place, on three seeds: float32 for the
    float64 cell, bfloat16 for the float32 one, each over the limit."""
    limit = _limit(bench, cell)
    fault_control(monkeypatch)
    for seed in (5, 6, 2**33 + 1):
        r = harness.run(bench, cell, seed, 0.05, False, device="cpu")
        assert r["correct"] is False
        assert r["checks"]["max_err"]["value"] > limit
