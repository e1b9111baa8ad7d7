"""``python -m mgard_tpu_torch`` against ``python -m mgard_tpu``, on the CPU.

Each subcommand runs through ``mgard_tpu_torch.cli.main([..., "--device",
"cpu"])`` and what it writes is read by the JAX package's CLI or API
(and the other way round), within the tolerance; ``inspect`` prints the
JAX CLI's lines; one ``inspect`` runs as ``python -m mgard_tpu_torch`` in
a process of its own.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import mgard_tpu
from mgard_tpu import cli as jcli

from mgard_tpu_torch import cli

from mdrx_fixture import write_mdrx

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPE = (17, 17, 17)
TOL = 1e-3


def _field(dtype=np.float32, seed=3):
    x = [np.linspace(0.0, 1.0, n) for n in SHAPE]
    v = np.sin(2 * np.pi * x[0])[:, None, None] \
        * np.cos(np.pi * x[1])[None, :, None] * x[2][None, None, :]
    rng = np.random.default_rng(seed)
    return (v + 1e-3 * rng.standard_normal(SHAPE)).astype(dtype)


def _run(main, argv, capsys):
    """Run a CLI's main and return its printed lines."""
    main(argv)
    return capsys.readouterr().out.strip().splitlines()


def _port(argv, capsys):
    return _run(cli.main, [*map(str, argv), "--device", "cpu"], capsys)


def _jax(argv, capsys):
    return _run(jcli.main, list(map(str, argv)), capsys)


@pytest.fixture
def raw(tmp_path):
    v = _field()
    path = tmp_path / "raw.bin"
    v.tofile(path)
    return v, path


@pytest.mark.parametrize("extra", [
    [],
    ["--lossless", "bitplane-lz4", "--mode", "rel"],
    ["--lossless", "bitplane-zstd", "--smoothness", "0"],
], ids=["bitplane", "lz4-rel", "zstd-s0"])
def test_compress_decompress_cross(raw, tmp_path, capsys, extra):
    """The port's container decodes in the JAX package and the JAX CLI's
    in the port's CLI, each within the tolerance; the lines printed are
    the JAX CLI's."""
    v, path = raw
    shape = ["--shape", *SHAPE]
    mine, theirs = tmp_path / "port.mgardtpu", tmp_path / "jax.mgardtpu"
    said = _port(["compress", "-i", path, "-o", mine, *shape, "-e", TOL,
                  *extra], capsys)
    assert re.fullmatch(rf"{v.nbytes} -> \d+ bytes \(ratio [\d.]+x\)",
                        said[0])
    _jax(["compress", "-i", path, "-o", theirs, *shape, "-e", TOL, *extra],
         capsys)
    bound = TOL * (float(np.abs(v).max()) if "rel" in extra else 1.0)
    out = mgard_tpu.decompress(mine.read_bytes())
    s = 0.0 if "0" in extra else np.inf
    if np.isinf(s):
        assert np.abs(out - v).max() <= bound
    back = tmp_path / "back.bin"
    said = _port(["decompress", "-i", theirs, "-o", back], capsys)
    assert said == [f"wrote {v.nbytes} bytes, shape {SHAPE}, float32"]
    got = np.fromfile(back, dtype=np.float32).reshape(SHAPE)
    if np.isinf(s):
        assert np.abs(got - v).max() <= bound
    else:
        from mgard_tpu_torch.hierarchy import Hierarchy
        from mgard_tpu_torch.ops import norms
        hier = Hierarchy(SHAPE)
        for o in (out, got):
            d = torch.from_numpy((o.astype(np.float64) - v))
            assert float(norms.norm(hier, d, s)) <= TOL


@pytest.mark.parametrize("fmt", ["mgard", "mgard-x"])
def test_compress_reference_formats(raw, tmp_path, capsys, fmt):
    """The reference CPU and MGARD-X buffers the port's CLI writes decode
    in the JAX package within the tolerance."""
    v, path = raw
    mine = tmp_path / f"port.{fmt}"
    _port(["compress", "-i", path, "-o", mine, "--shape", *SHAPE, "-e",
           TOL, "--format", fmt], capsys)
    buf = mine.read_bytes()
    assert buf[:5] == b"MGARD"
    assert np.abs(mgard_tpu.decompress(buf) - v).max() <= TOL
    back = tmp_path / "back.bin"
    _port(["decompress", "-i", mine, "-o", back], capsys)
    got = np.fromfile(back, dtype=np.float32).reshape(SHAPE)
    assert np.abs(got - v).max() <= TOL


def test_inspect_prints_the_jax_lines(raw, tmp_path, capsys):
    v, path = raw
    mine = tmp_path / "port.mgardtpu"
    _port(["compress", "-i", path, "-o", mine, "--shape", *SHAPE, "-e",
           TOL, "-m", "rel"], capsys)
    said = _port(["inspect", "-i", mine], capsys)
    assert said == _jax(["inspect", "-i", mine], capsys)
    assert said[0] == "dtype       : float32" and len(said) == 10


def test_inspect_as_a_module(raw, tmp_path, capsys):
    """``python -m mgard_tpu_torch inspect`` in a process of its own."""
    v, path = raw
    mine = tmp_path / "port.mgardtpu"
    _port(["compress", "-i", path, "-o", mine, "--shape", *SHAPE, "-e",
           TOL], capsys)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "mgard_tpu_torch",
                           "inspect", "-i", str(mine), "--device", "cpu"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines() \
        == _jax(["inspect", "-i", mine], capsys)


def test_refactor_reconstruct(raw, tmp_path, capsys):
    """The port's MDR directory reconstructs in the JAX CLI, and in the
    port's, within the tolerance."""
    v, path = raw
    d = tmp_path / "mdr"
    said = _port(["refactor", "-i", path, "-o", d, "--shape", *SHAPE],
                 capsys)
    assert said[0].startswith(f"refactored {v.nbytes} bytes into ")
    assert (d / "metadata.bin").exists()
    for main in (_port, _jax):
        out_path = tmp_path / f"rec_{main.__name__}.bin"
        said = main(["reconstruct", "-i", d, "-o", out_path, "-e", 1e-2],
                    capsys)
        assert said[0].startswith(f"reconstructed {v.nbytes} bytes from ")
        got = np.fromfile(out_path, dtype=np.float32).reshape(SHAPE)
        assert np.abs(got - v).max() <= 1e-2


def test_reconstruct_mdrx(tmp_path, capsys):
    """An mdr-x directory (the test writer's) reconstructs in both CLIs to
    the same values; a finite smoothness is refused as in the JAX CLI."""
    v = _field(np.float64)
    d = tmp_path / "mdrx"
    write_mdrx(d, v, device="cpu")
    outs = []
    for main in (_port, _jax):
        out_path = tmp_path / f"x_{main.__name__}.bin"
        said = main(["reconstruct", "-i", d, "-o", out_path, "-e", 1e-4,
                     "--format", "mdr-x"], capsys)
        assert said[0].startswith(f"reconstructed {v.nbytes} bytes "
                                  "(mdr-x artifact)")
        outs.append(np.fromfile(out_path, dtype=np.float64).reshape(SHAPE))
    assert np.abs(outs[0] - outs[1]).max() <= 1e-12 * np.abs(v).max()
    assert np.abs(outs[0] - v).max() <= 1e-4
    with pytest.raises(SystemExit):
        _port(["reconstruct", "-i", d, "-o", tmp_path / "x", "-e", 1e-4,
               "--format", "mdr-x", "-s", "0"], capsys)


def test_zfp_both_formats(raw, tmp_path, capsys):
    """The native stream decodes in the JAX CLI; the zfp-x stream is the
    JAX CLI's byte for byte and decodes in both."""
    v, path = raw
    shape = ["--shape", *SHAPE]
    nat = tmp_path / "port.zfpt"
    said = _port(["zfp", "-i", path, "-o", nat, *shape, "--rate", 16],
                 capsys)
    assert said[0].endswith("(fixed rate 16 bits/value)")
    for main in (_port, _jax):
        out_path = tmp_path / f"z_{main.__name__}.bin"
        said = main(["zfp-decompress", "-i", nat, "-o", out_path], capsys)
        assert said == [f"wrote {v.nbytes} bytes, shape {SHAPE}"]
    a, b = (np.fromfile(tmp_path / f"z_{m}.bin", dtype=np.float32)
            for m in ("_port", "_jax"))
    assert np.abs(a - b).max() <= 1e-6 and np.abs(a - v.ravel()).max() < 1e-2
    mine, theirs = tmp_path / "port.zfpx", tmp_path / "jax.zfpx"
    _port(["zfp", "-i", path, "-o", mine, *shape, "--format", "zfp-x"],
          capsys)
    _jax(["zfp", "-i", path, "-o", theirs, *shape, "--format", "zfp-x"],
         capsys)
    assert mine.read_bytes() == theirs.read_bytes()
    back = tmp_path / "zx.bin"
    _port(["zfp-decompress", "-i", theirs, "-o", back, "--format", "zfp-x",
           *shape], capsys)
    jback = tmp_path / "zxj.bin"
    _jax(["zfp-decompress", "-i", theirs, "-o", jback, "--format", "zfp-x",
          *shape], capsys)
    assert back.read_bytes() == jback.read_bytes()
    with pytest.raises(SystemExit):
        _port(["zfp-decompress", "-i", theirs, "-o", back, "--format",
               "zfp-x"], capsys)


def test_wrong_size_and_no_card(raw, tmp_path, capsys):
    """A file that does not hold the shape exits with a message; without
    a card and without --device cpu every subcommand raises."""
    v, path = raw
    with pytest.raises(SystemExit, match="shape needs"):
        _port(["compress", "-i", path, "-o", tmp_path / "x", "--shape", 9,
               9, "-e", TOL], capsys)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["inspect", "-i", str(path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["compress", "-i", str(path), "-o", str(tmp_path / "y"),
                  "--shape", *map(str, SHAPE), "-e", str(TOL)])
