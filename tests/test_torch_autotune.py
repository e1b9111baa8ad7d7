"""``mgard_tpu_torch.utils.autotune`` and the knobs read at import, against
``mgard_tpu``, on the CPU.

The first cases mirror ``tests/test_autotune.py`` one for one with the
port's functions (``device="cpu"``); then the port's table keys against
the JAX package's, the codec pick's ratio against JAX's, a sweep whose
candidate is a real ``probe`` subprocess, and the knobs, one subprocess
a setting: ``MGARD_TPU_CHUNK_GROUPS=1024`` (a port process; containers
record the width and decode in a default process of either package),
``MGARD_TPU_BP_CB=8`` (both packages in one process: the chunk tile,
which no header records) and ``MGARD_TPU_GPK=0 MGARD_TPU_XK=0``; an
out-of-range ``MGARD_TPU_BP_CB`` by a fresh copy of each package's
module.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mgard_tpu
from mgard_tpu.config import Config as JConfig, Lossless as JLossless
from mgard_tpu.models.compressor import get_compressor as jget_compressor
from mgard_tpu.utils import autotune as jautotune

import mgard_tpu_torch as mt
from mgard_tpu_torch.config import Config, Lossless
from mgard_tpu_torch.io import format as fmt
from mgard_tpu_torch.models.compressor import get_compressor
from mgard_tpu_torch.ops import bitplane, transform
from mgard_tpu_torch.ops import extract_kernels as xk
from mgard_tpu_torch.ops import stencil_kernels as sk
from mgard_tpu_torch.utils import autotune

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = 1e-3

# The head of every subprocess that imports both packages: JAX pinned to
# the CPU with 64-bit mode on, as conftest sets them (the quantum
# arithmetic, and so the stream bytes, depend on it).
_BOTH = (
    "import jax\n"
    "jax.config.update('jax_platforms', 'cpu')\n"
    "jax.config.update('jax_enable_x64', True)\n"
    "import json, sys\n"
    "import numpy as np\n"
    "import mgard_tpu\n"
    "import mgard_tpu_torch as mt\n"
    "from mgard_tpu.config import Config as JConfig, Lossless as JLossless\n"
)


def _env(**knobs):
    """This process's environment with no autotune table and only the
    knobs ``knobs`` set."""
    env = {k: v for k, v in os.environ.items()
           if k not in autotune.KNOB_ENV.values()}
    return dict(env, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
                MGARD_TPU_AUTOTUNE="/nonexistent/autotune.json", **knobs)


def _run(argv, knobs, timeout=300):
    """Run ``python argv`` with :func:`_env` and return its last stdout
    line as JSON."""
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT,
                          env=_env(**knobs), capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _fresh(module):
    """A new copy of ``module`` executed now, under the current
    environment (not entered in ``sys.modules``)."""
    spec = importlib.util.find_spec(module)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _field(shape=(33, 33, 33), seed=7, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# --- the cases of tests/test_autotune.py ------------------------------------

def test_autotune_picks_and_persists(tmp_path):
    path = tmp_path / "table.json"
    res = autotune.autotune((33, 33), np.float32, save=True, path=path,
                            iters=1, device="cpu")
    assert res["best"] in (Lossless.BITPLANE, Lossless.BITPLANE_GROUP)
    assert path.exists()
    cfg = autotune.lookup((33, 33), np.float32, path=path, device="cpu")
    assert cfg is not None
    assert cfg.lossless == res["best"]


def test_lookup_missing_returns_none(tmp_path):
    assert autotune.lookup((5, 5), np.float64, path=tmp_path / "none.json",
                           device="cpu") is None


def test_apply_tuned_seeds_env(tmp_path, monkeypatch):
    """apply_tuned seeds env defaults from the persisted sweep winners;
    a variable the user set wins, and only known knobs are applied."""
    path = tmp_path / "table.json"
    path.write_text(json.dumps({
        "default_knobs": {"MGARD_TPU_CHUNK_GROUPS": "1024",
                          "MGARD_TPU_BP_CB": "8",
                          "NOT_A_KNOB": "evil"},
    }))
    # a copy of the environment, so that nothing seeded here outlives
    # the test
    monkeypatch.setattr(os, "environ", _env(MGARD_TPU_BP_CB="2"))
    os.environ.pop("NOT_A_KNOB", None)
    autotune.apply_tuned(path)
    assert os.environ["MGARD_TPU_CHUNK_GROUPS"] == "1024"
    assert os.environ["MGARD_TPU_BP_CB"] == "2"
    assert "NOT_A_KNOB" not in os.environ


def test_apply_tuned_leaves_the_kernels_on(tmp_path, monkeypatch):
    """A table whose sweep chose GPK off seeds its width but not the
    switch: only a variable the user sets turns K5/K6 off."""
    path = tmp_path / "table.json"
    path.write_text(json.dumps({
        "default_knobs": {"MGARD_TPU_CHUNK_GROUPS": "2048",
                          "MGARD_TPU_GPK": "0"},
    }))
    monkeypatch.setattr(os, "environ", _env())
    autotune.apply_tuned(path)
    assert os.environ["MGARD_TPU_CHUNK_GROUPS"] == "2048"
    assert "MGARD_TPU_GPK" not in os.environ
    monkeypatch.setattr(os, "environ", _env(MGARD_TPU_GPK="0"))
    autotune.apply_tuned(path)
    assert os.environ["MGARD_TPU_GPK"] == "0"


@pytest.mark.parametrize("clock,want", [
    # the first pair's longer run is the shorter: measured again
    ([0, 10, 0, 5, 0, 1, 0, 3], 1.0),
    ([0, 1, 0, 5], 2.0)])
def test_slope_measures_again_until_positive(monkeypatch, clock, want):
    ticks = iter(clock)
    monkeypatch.setattr(autotune.time, "perf_counter", lambda: next(ticks))
    assert autotune._slope(lambda: None, 2, 1, 2, torch.device("cpu")) \
        == want


def test_slope_without_a_positive_reading_raises(monkeypatch):
    """A probe whose runs never give a positive slope raises (its sweep
    candidate then fails) instead of reading a nanosecond a call."""
    monkeypatch.setattr(autotune.time, "perf_counter", lambda: 0.0)
    with pytest.raises(RuntimeError, match="no positive timing slope"):
        autotune._slope(lambda: None, 1, 1, 3, torch.device("cpu"))


def test_config_tuned_falls_back_to_defaults():
    cfg = Config.tuned((7, 7, 7), np.float32, device="cpu")
    assert cfg == Config()


def test_container_records_chunk_groups():
    """Containers record the codec width, and the field round-trips."""
    v = np.linspace(0, 1, 17 * 17, dtype=np.float32).reshape(17, 17)
    buf = mt.compress(v, 1e-3, device="cpu")
    header, _ = fmt.read_container(buf)
    assert (header.chunk_groups or 2048) == bitplane.CHUNK_GROUPS
    h2 = dataclasses.replace(header, chunk_groups=1024)
    assert fmt.Header.unpack(h2.pack()).chunk_groups == 1024


@pytest.mark.parametrize("dtype,widths,tol", [
    (np.float32, (1024, 2048, 4096), 1e-3),
    (np.float64, (1024, 2048), 1e-6)], ids=["float32", "float64-wide"])
def test_any_width_container_decodes_in_default_process(dtype, widths, tol):
    """A container written at any chunk width decodes in a default
    process of either package, to the same values (the codec is lossless
    over the quantized integers)."""
    v = _field((17, 17, 17), 7 if dtype == np.float32 else 11, dtype)
    cfg = Config(lossless=Lossless.BITPLANE, adapt_lossless=False)
    outs = []
    for width in widths:
        comp = get_compressor(v.shape, v.dtype, config=cfg,
                              chunk_groups=width, device="cpu")
        buf = comp.compress(v, tol)
        # 2048 is the implicit on-wire width when the field is absent
        assert (fmt.read_container(buf)[0].chunk_groups or 2048) == width
        out = mt.decompress(buf, device="cpu")
        assert np.max(np.abs(out - v)) <= tol
        if width == 1024:
            assert np.max(np.abs(mgard_tpu.decompress(buf) - v)) <= tol
        outs.append(out)
    for a in outs[1:]:
        assert np.array_equal(outs[0], a)


def test_env_width_container_decodes_in_default_process(tmp_path):
    """MGARD_TPU_CHUNK_GROUPS=1024 in a port process: it writes width 1024
    into its header and decodes the JAX package's width-1024 container
    (``get_compressor(chunk_groups=1024)``, the bytes that the JAX
    package writes under that setting: ``tests/test_autotune.py``); this
    default process decodes the port's container with both packages,
    within the tolerance, the port's output the port's same-width encode
    made here bit for bit."""
    v = _field((17, 17, 17), seed=3)
    np.save(tmp_path / "v.npy", v)
    jcfg = JConfig(lossless=JLossless.BITPLANE, adapt_lossless=False)
    (tmp_path / "jax.bin").write_bytes(jget_compressor(
        v.shape, v.dtype, config=jcfg, chunk_groups=1024).compress(v, TOL))
    said = _run(["-c", (
        "import json\n"
        "import numpy as np\n"
        "import mgard_tpu_torch as mt\n"
        "from mgard_tpu_torch.ops import bitplane\n"
        "v = np.load(%r)\n"
        "cfg = mt.Config(lossless=mt.Lossless.BITPLANE, "
        "adapt_lossless=False)\n"
        "open(%r, 'wb').write(mt.compress(v, 1e-3, config=cfg, "
        "device='cpu'))\n"
        "out = mt.decompress(open(%r, 'rb').read(), device='cpu')\n"
        "print(json.dumps([bitplane.CHUNK_GROUPS, "
        "float(np.abs(out - v).max())]))\n"
    ) % (str(tmp_path / "v.npy"), str(tmp_path / "port.bin"),
         str(tmp_path / "jax.bin"))], {"MGARD_TPU_CHUNK_GROUPS": "1024"})
    assert said[0] == 1024 and said[1] <= TOL
    buf = (tmp_path / "port.bin").read_bytes()
    assert fmt.read_container(buf)[0].chunk_groups == 1024
    cfg = Config(lossless=Lossless.BITPLANE, adapt_lossless=False)
    same = mt.decompress(get_compressor(
        v.shape, v.dtype, config=cfg, chunk_groups=1024,
        device="cpu").compress(v, TOL), device="cpu")
    out = mt.decompress(buf, device="cpu")
    assert np.array_equal(out, same)
    assert np.max(np.abs(out - v)) <= TOL
    assert np.max(np.abs(mgard_tpu.decompress(buf) - v)) <= TOL


def test_sweep_knobs_persists_per_shape_entries(tmp_path):
    """The knob table is keyed by (device, dtype, size bucket): two swept
    shapes persist two entries, and Config.tuned picks each one's
    winners."""
    path = tmp_path / "table.json"

    def runner_small(knobs):
        cg = int(knobs.get("chunk_groups", 2048))
        return {"gbps": 10.0 + (1.0 if cg == 1024 else 0.0), "ratio": 2.0}

    def runner_big(knobs):
        cg = int(knobs.get("chunk_groups", 2048))
        return {"gbps": 10.0 + (1.0 if cg == 4096 else 0.0), "ratio": 2.0}

    grid = {"chunk_groups": [1024, 2048, 4096]}
    autotune.sweep_knobs((64, 64, 64), np.float32, grid=grid, path=path,
                         log=lambda *a: None, _runner=runner_small,
                         device="cpu")
    autotune.sweep_knobs((512, 512, 512), np.float32, grid=grid, path=path,
                         log=lambda *a: None, _runner=runner_big,
                         device="cpu")

    table = autotune.load_table(path)
    assert len(table["knobs"]) == 2
    assert table["default_knobs"]["MGARD_TPU_CHUNK_GROUPS"] == "4096"
    cfg_small = autotune.lookup((64, 64, 64), np.float32, path=path,
                                device="cpu")
    cfg_big = autotune.lookup((512, 512, 512), np.float32, path=path,
                              device="cpu")
    assert cfg_small.chunk_groups == 1024
    assert cfg_big.chunk_groups == 4096
    assert isinstance(cfg_small, Config)
    # the JAX package reads the port's table the same way
    assert jautotune.lookup((64, 64, 64), np.float32,
                            path=path).chunk_groups == 1024


# --- the port against the JAX package ---------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((33, 33), np.float32), ((5, 5), np.float64), ((512, 512, 512),
                                                   np.float32),
    ((1,), np.float32), ((7, 7, 7), np.float64)])
def test_key_matches_jax_on_the_cpu(shape, dtype):
    assert autotune._key(shape, dtype, device="cpu") \
        == jautotune._key(shape, dtype)


def test_config_tuned_reads_the_table(tmp_path, monkeypatch):
    """Config.tuned reads the default table (MGARD_TPU_AUTOTUNE at
    import): the codec pick and the swept width of its key."""
    path = tmp_path / "table.json"
    key = autotune._key((64, 64, 64), np.float32, device="cpu")
    path.write_text(json.dumps({
        key: {"lossless": int(Lossless.BITPLANE_GROUP)},
        "knobs": {key: {"MGARD_TPU_CHUNK_GROUPS": "2048"}}}))
    monkeypatch.setattr(autotune, "_DEFAULT_PATH", path)
    cfg = Config.tuned((64, 64, 64), np.float32, device="cpu")
    assert cfg == Config(lossless=Lossless.BITPLANE_GROUP, chunk_groups=2048)
    assert Config.tuned((8, 8), np.float32, device="cpu") == Config()


def test_autotune_ratio_matches_jax(tmp_path):
    """The port's pick at (33, 33) has the ratio, within 1%, that the
    JAX autotuner measures for the same candidate."""
    res = autotune.autotune((33, 33), np.float32, iters=1, save=False,
                            device="cpu")
    jres = jautotune.autotune((33, 33), np.float32, iters=1, save=False)
    best = int(res["best"])
    assert set(res["results"]) == set(jres["results"])
    ratio, jratio = res["results"][best]["ratio"], \
        jres["results"][best]["ratio"]
    assert abs(ratio / jratio - 1) <= 0.01, (ratio, jratio)


def test_sweep_runs_probe_subprocesses(tmp_path, monkeypatch):
    """Without a runner, each candidate is a ``python -m
    mgard_tpu_torch.utils.autotune probe --device cpu`` subprocess under
    its knobs: its ratio is the in-process probe's at that width, and the
    winners and default_knobs land in the table."""
    path = tmp_path / "table.json"
    monkeypatch.setattr(os, "environ", _env())
    res = autotune.sweep_knobs((17, 17, 17), np.float32,
                               grid={"chunk_groups": [1024]}, path=path,
                               log=lambda *a: None, device="cpu")
    assert res["winners"] == {"chunk_groups": 1024}
    said = res["results"]["chunk_groups"]["1024"]
    assert set(said) == {"gbps", "t_enc_ms", "t_dec_ms", "ratio"}
    # a positive slope for each direction (GB/s at 17^3 on a loaded CPU
    # can round to 0.0 at the table's four decimals; the times cannot)
    assert said["t_enc_ms"] > 0 and said["t_dec_ms"] > 0
    monkeypatch.setattr(bitplane, "CHUNK_GROUPS", 1024)
    here = autotune.probe((17, 17, 17), np.float32, iters=1, device="cpu")
    assert said["ratio"] == round(here["ratio"], 4)
    table = autotune.load_table(path)
    assert table["default_knobs"] == {"MGARD_TPU_CHUNK_GROUPS": "1024"}


def test_bp_cb_containers_cross_decode(tmp_path):
    """MGARD_TPU_BP_CB=8 pads every segment's chunks to 8, which sets the
    exponent array's length on the wire and no header records.  In one
    process under that setting, the JAX package's segmented and LZ4
    containers decode with the port and the port's with the JAX package,
    within the tolerance; in this default process both packages refuse
    all four (the reference's own behaviour)."""
    v = _field((17, 17, 17), seed=5)
    np.save(tmp_path / "v.npy", v)
    code = _BOTH + (
        "v = np.load(%r)\n"
        "out = {}\n"
        "for name in ('BITPLANE', 'BITPLANE_LZ4'):\n"
        "    jbuf = mgard_tpu.compress(v, 1e-3, config=JConfig(\n"
        "        lossless=JLossless[name], adapt_lossless=False))\n"
        "    pbuf = mt.compress(v, 1e-3, config=mt.Config(\n"
        "        lossless=mt.Lossless[name], adapt_lossless=False),\n"
        "        device='cpu')\n"
        "    open(%r + name, 'wb').write(jbuf)\n"
        "    open(%r + name, 'wb').write(pbuf)\n"
        "    out[name] = [\n"
        "        float(np.abs(mt.decompress(jbuf, device='cpu') - v).max()),\n"
        "        float(np.abs(mgard_tpu.decompress(pbuf) - v).max())]\n"
        "from mgard_tpu_torch.ops import bitplane\n"
        "out['tile'] = bitplane.CHUNK_TILE\n"
        "print(json.dumps(out))\n"
    ) % (str(tmp_path / "v.npy"), str(tmp_path / "jax_"),
         str(tmp_path / "port_"))
    said = _run(["-c", code], {"MGARD_TPU_BP_CB": "8"})
    assert said.pop("tile") == 8
    for name, errs in said.items():
        assert max(errs) <= TOL, (name, errs)
    assert bitplane.CHUNK_TILE == 4
    for name in ("BITPLANE", "BITPLANE_LZ4"):
        for who in ("jax_", "port_"):
            buf = (tmp_path / (who + name)).read_bytes()
            with pytest.raises(ValueError):
                mt.decompress(buf, device="cpu")
            with pytest.raises(ValueError):
                mgard_tpu.decompress(buf)


def test_knobs_read_at_import(monkeypatch):
    """MGARD_TPU_GPK=0 and MGARD_TPU_XK=0 turn the port's switches off at
    import (a subprocess); an out-of-range MGARD_TPU_BP_CB makes the
    module that reads it raise in both packages (the JAX package's Pallas
    codec module, the port's bitplane module; each a fresh copy executed
    under that setting)."""
    assert transform._GPK and transform._XK
    said = _run(["-c", "import json\n"
                 "from mgard_tpu_torch.ops import transform\n"
                 "print(json.dumps([transform._GPK, transform._XK]))\n"],
                {"MGARD_TPU_GPK": "0", "MGARD_TPU_XK": "0"})
    assert said == [False, False]
    from mgard_tpu.ops import bitplane as jbitplane
    for bad in ("9", "0"):
        monkeypatch.setenv("MGARD_TPU_BP_CB", bad)
        monkeypatch.setattr(jbitplane, "CHUNK_TILE", int(bad))
        with pytest.raises(AssertionError,
                           match=r"MGARD_TPU_BP_CB must be in \[1, 8\]"):
            _fresh("mgard_tpu.ops.pallas_kernels")
        with pytest.raises(ValueError,
                           match=r"MGARD_TPU_BP_CB must be in \[1, 8\]"):
            _fresh("mgard_tpu_torch.ops.bitplane")
    monkeypatch.setenv("MGARD_TPU_BP_CB", "8")
    assert _fresh("mgard_tpu_torch.ops.bitplane").CHUNK_TILE == 8


def test_gpk_and_xk_switches_gate_the_kernels(monkeypatch):
    """With ``_GPK`` and ``_XK`` off the transform calls neither K5/K6 nor
    K1, even where their gates admit a level; on, it calls them."""
    shape = (8, 128, 128)       # the finest level passes both gates
    hier = mt.Hierarchy(shape)
    v = torch.from_numpy(_field(shape))
    called = []

    def kernel(name, fn):
        def wrapped(*args):
            called.append(name)
            return fn(*args)
        return wrapped

    assert sk.gpk_structure_ok(hier, hier.L)
    finest = lambda h, l, A: l == hier.L      # noqa: E731
    monkeypatch.setattr(sk, "gpk_supported", finest)
    monkeypatch.setattr(xk, "extract_supported", finest)
    monkeypatch.setattr(sk, "gpk_detail", kernel("K5", sk.gpk_detail))
    monkeypatch.setattr(sk, "gpk_prolong_add",
                        kernel("K6", sk.gpk_prolong_add))
    monkeypatch.setattr(xk, "extract_coarse_3d",
                        kernel("K1", xk.extract_coarse_3d))
    monkeypatch.setattr(transform, "_GPK", False)
    monkeypatch.setattr(transform, "_XK", False)
    off = transform.recompose(hier, transform.decompose(hier, v))
    assert called == []
    monkeypatch.setattr(transform, "_GPK", True)
    monkeypatch.setattr(transform, "_XK", True)
    on = transform.recompose(hier, transform.decompose(hier, v))
    assert {"K1", "K5", "K6"} <= set(called)
    torch.testing.assert_close(on, off, rtol=0, atol=1e-5)
    torch.testing.assert_close(off, v, rtol=0, atol=1e-5)
