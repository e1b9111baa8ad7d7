"""mgard_tpu_torch's log and debug utilities (after tests/test_utils.py),
on the CPU: the Timer's report, Config.log_level, the debug checks of the
compressor, and debug mode's wait for each kernel launch, whose fault
raises naming the kernel (the launcher and the card faked)."""

import contextlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mgard_tpu_torch as mt
from mgard_tpu_torch.ops import _build
from mgard_tpu_torch.utils import debug, log

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_timer_reports(capsys):
    old = log.level
    log.level = log.TIME
    try:
        with log.Timer("phase", nbytes=10**9) as t:
            pass
        assert t.seconds >= 0
        err = capsys.readouterr().err
        assert "phase" in err and "GB/s" in err
        log.level = log.ERR
        with log.Timer("quiet"):
            pass
        log.log(log.DBG, "not at this level")
        assert capsys.readouterr().err == ""
    finally:
        log.level = old


def test_log_level_from_config_and_the_compress_timer(capsys):
    """Config(log_level=TIME) sets the level, and compress reports its
    device part ("compress (device)") with its GB/s."""
    old = log.level
    try:
        mt.Config(log_level=log.TIME | log.ERR)
        assert log.level == log.TIME | log.ERR
        mt.Config()                 # 0 leaves the level as it is
        assert log.level == log.TIME | log.ERR
        v = np.random.default_rng(2).random((9, 9)).astype(np.float32)
        mt.compress(v, 1e-2, device="cpu")
        err = capsys.readouterr().err
        assert "[mgard-tpu time] compress (device):" in err and "GB/s" in err
    finally:
        log.level = old


def test_debug_mode_checks():
    """Debug mode's compressor checks pass on a good round trip and raise
    on a false condition; off, check does nothing."""
    from test_compress_e2e import smooth_field

    assert not debug.enabled()
    debug.check(False, "ignored while off")
    debug.enable()
    try:
        assert debug.enabled()
        v = smooth_field((33, 33), seed=77).astype(np.float32)
        buf = mt.compress(v, 1e-3, device="cpu")
        out = mt.decompress(buf, device="cpu")
        assert np.abs(out - v).max() <= 1e-3
        with pytest.raises(AssertionError, match="boom"):
            debug.check(False, "boom")
    finally:
        debug.disable()
    assert not debug.enabled()


def test_debug_mode_catches_a_non_finite_decode(monkeypatch):
    """The decoded output's finite check (the JAX package's at
    models/compressor.py:562-565)."""
    v = np.random.default_rng(4).random((17, 17)).astype(np.float32)
    buf = mt.compress(v, 1e-3, device="cpu")
    comp = mt.api.compressor_for(mt.io.format.read_container(buf)[0],
                                 "cpu")
    real = type(comp)._decode_parsed
    monkeypatch.setattr(type(comp), "_decode_parsed",
                        lambda self, h, s: real(self, h, s) * np.nan)
    mt.decompress(buf, device="cpu")           # off: no check
    debug.enable()
    try:
        with pytest.raises(AssertionError, match="non-finite"):
            mt.decompress(buf, device="cpu")
    finally:
        debug.disable()


@pytest.fixture
def fake_card(monkeypatch):
    """A launcher library, device guard and stream that record, and a
    synchronize that records and fails for a kernel named 'bad'."""
    synced = []
    last = []

    class Lib:
        def __getattr__(self, name):
            def launcher(*args):
                last.append(name)
                return 0
            return launcher

    def synchronize(device=None):
        synced.append(torch.device(device))
        if last and last[-1] == "mgard_bad":
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type(
        "S", (), {"cuda_stream": 7}))
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return synced


def test_debug_mode_waits_for_each_launch(fake_card):
    synced = fake_card
    card = torch.device("cuda", 1)
    _build.launch("mgard_good", 1, device=card)
    _build.launch("mgard_bad", 1, device=card)
    assert synced == []                     # off: no wait
    debug.enable()
    try:
        _build.launch("mgard_good", 1, device=card)
        assert synced == [card]
        with pytest.raises(RuntimeError, match="mgard_bad: the kernel "
                           "failed on cuda:1: CUDA error: an illegal"):
            _build.launch("mgard_bad", 1, device=card)
    finally:
        debug.disable()


def test_debug_from_the_environment():
    """MGARD_TPU_DEBUG=1 at import turns debug mode on."""
    env = dict(os.environ, MGARD_TPU_DEBUG="1", PYTHONPATH=str(ROOT))
    code = ("from mgard_tpu_torch.utils import debug; "
            "print(debug.enabled())")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr
