"""The port's six examples (``examples/torch_*.py``) on the CPU at small
sizes: each runs its ``main`` with ``--device cpu`` in this process and
raises if an error exceeds its bound; none imports jax, mgard_tpu or, at
module level, zstandard."""

import pathlib
import re
import runpy

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"

# each example with the argument that makes it small
CASES = {
    "torch_basic_compression": ["--n", "33"],
    "torch_interop": ["--n", "17"],
    "torch_multichip_sharded": ["--edge", "17"],
    "torch_progressive_mdr": ["--n", "33"],
    "torch_qoi_preservation": ["--n", "33"],
    "torch_xgc_case_study": ["0.03125"],
}


def test_every_example_has_a_port_counterpart():
    jax_ones = {p.stem for p in EXAMPLES.glob("*.py")
                if not p.stem.startswith("torch_")}
    assert {f"torch_{n}" for n in jax_ones} == set(CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_within_its_bounds(name, capsys):
    main = runpy.run_path(str(EXAMPLES / f"{name}.py"))["main"]
    main([*CASES[name], "--device", "cpu"])
    assert capsys.readouterr().out.strip()


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_names_no_jax(name):
    src = (EXAMPLES / f"{name}.py").read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|mgard_tpu)\b", src,
                         re.M)
    assert not re.search(r"^(import|from)\s+zstandard\b", src, re.M)
