"""The control at the size of the cells ``miranda.linf-1e-8`` and
``nyx-512.tight`` on the card (``python -m pytest portbench -m card``):
the field kept one precision lower (float32 for Miranda's float64,
bfloat16 for Nyx's float32) in the program's place must come out not
correct on every seed."""

import json
from pathlib import Path

import pytest

from portbench import harness
from portbench.test_portbench_run import fault_control

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.card
@pytest.mark.parametrize("cell", ["miranda.linf-1e-8", "nyx-512.tight"])
def test_control_at_the_new_cells_size(card, monkeypatch, cell):
    """Each new cell at its own size, with the control in the program's
    place on three seeds: every run comes out not correct, its max_err
    over the limit.  Prints the readings, one JSON line a cell."""
    knobs = harness.pin_knobs()
    bench = harness.Bench(ROOT)
    limit = bench.traffic(bench.workload(cell)["traffic"])["abs_tol"]
    fault_control(monkeypatch)
    readings = {}
    try:
        for seed in (7200000001, 7200000002, 7200000003):
            r = harness.run(bench, cell, seed, 1.0, False, device="cuda")
            readings[seed] = r["checks"]["max_err"]["value"]
            assert r["correct"] is False and readings[seed] > limit
    finally:
        knobs.cleanup()
        print(json.dumps({"cell": cell, "control_max_err": readings,
                          "limit": limit}))
