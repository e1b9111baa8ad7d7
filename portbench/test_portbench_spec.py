"""BENCHMARK.json against the contract's form, and a cell added from new
files only."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_form(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p.split("/")
               for p in spec["paths"])
    assert 1 <= len(spec["command"]) <= 32
    assert all(_line(w) for w in spec["command"])
    assert isinstance(spec["run_seconds"], int) \
        and 1 <= spec["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for kind, keys in KEYS.items():
        names = [e["name"] for e in spec[kind]]
        assert len(names) == len(set(names)), kind
        for e in spec[kind]:
            extra = set(e) - keys - ({"workloads"} if kind in (
                "end_to_end", "per_layer") else set())
            assert keys <= set(e) and not extra, (kind, e["name"], extra)
            assert NAME.match(e["name"]), e["name"]


def test_names_units_and_references(spec):
    configs = {c["name"] for c in spec["configs"]}
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    for c in spec["configs"]:
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("portbench/") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in spec["workloads"]:
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m for m in spec["end_to_end"]
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in spec["per_layer"])


def test_every_file_found_by_name(spec):
    bench = harness.Bench(ROOT)
    for w in spec["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["name"] == w["config"]
        assert bench.traffic(w["traffic"])["name"] == w["traffic"]
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]))
    for kernel in ("K5", "K6", "S1"):
        assert callable(bench.kernel(kernel).bytes_per_call)
    assert bench.kernel_map().symbols
    assert bench.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


def tiny_root(tmp_path, shape=(17, 17, 17), nfields=3):
    """A checkout-like directory whose BENCHMARK.json holds one new cell,
    ``tiny.linf``, and a new per-layer metric, made of new files only:
    the harness's files are copied, none is edited."""
    pkg = tmp_path / "portbench"
    for part in ("traffic", "metrics", "kernels", "kernelmap", "configs"):
        shutil.copytree(ROOT / "portbench" / part, pkg / part)
    shutil.copy(ROOT / "portbench" / "peaks.json", pkg / "peaks.json")
    with open(ROOT / "portbench" / "configs" / "nyx-512.json") as f:
        cfg = json.load(f)
    cfg.update(name="tiny", shape=list(shape),
               fields=[f"f{i}" for i in range(nfields)])
    (pkg / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "tiny.json").write_text(json.dumps(
        dict(json.loads((pkg / "traffic" / "linf.json").read_text()),
             name="tiny")))
    (pkg / "metrics" / "device_ms.compress.py").write_text(
        "def read(t):\n"
        "    return t.layer_ms('compress', ('transform', 'codec', 's1',"
        " 'cublas', 'torch'))\n")
    (pkg / "kernels" / "K1.py").write_text(
        "def bytes_per_call(shape, itemsize, launches):\n"
        "    return None\n")
    (pkg / "kernelmap" / "extra.json").write_text(json.dumps(
        {"symbols": {"tiny_new_kernel": {"kernel": "K99",
                                         "layer": "codec"}}}))
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec["configs"].append({"name": "tiny", "source": "a test",
                            "file": "portbench/configs/tiny.json",
                            "reduced": ["shape"], "why": "a test"})
    spec["workloads"].append({"name": "tiny.linf", "config": "tiny",
                              "traffic": "tiny", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny.linf")
    spec["per_layer"].append({
        "name": "device_ms.compress", "unit": "ms", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "compress_GBps", "workloads": ["tiny.linf"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def test_new_cell_from_new_files(tmp_path):
    bench = harness.Bench(tiny_root(tmp_path))
    assert bench.config("tiny")["shape"] == [17, 17, 17]
    assert bench.traffic("tiny")["abs_tol"] == 1e-3
    assert [m["name"] for m in bench.metrics("per_layer", "tiny.linf")] \
        == ["device_ms.compress"]
    assert bench.kernel("K1").bytes_per_call((17,), 4, 1) is None
    assert bench.kernel_map().classify("void tiny_new_kernel(int)") \
        == ("K99", "codec")
    assert callable(bench.reader("device_ms.compress"))


def test_modules_of_a_run_not_forbidden(tmp_path):
    """A run through the loaders on the CPU loads no module whose
    top-level name is forbidden."""
    from portbench import reference, trace  # noqa: F401
    bench = harness.Bench(tiny_root(tmp_path, shape=(9, 9), nfields=1))
    harness.run(bench, "tiny.linf", 3, 0.02, False, device="cpu")
    assert harness.forbidden_modules() == [], sorted(
        m for m in sys.modules if m.split(".")[0] in harness.FORBIDDEN)
