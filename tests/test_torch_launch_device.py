"""Every CUDA kernel wrapper of mgard_tpu_torch launches under the device
of its tensors, on that device's current stream, and refuses tensors on
two devices -- checked on the CPU.

No card is needed: the tensors are CPU tensors that report a CUDA device
(``FakeCuda``), the tensor factories the wrappers call hand such tensors
back for a CUDA device, and ``_build.lib``, ``torch.cuda.device`` and
``torch.cuda.current_stream`` are replaced by recorders.
"""

import contextlib

import numpy as np
import pytest
import torch

import mgard_tpu_torch as mt
from mgard_tpu_torch.ops import _build
from mgard_tpu_torch.ops import bp_kernels as bk
from mgard_tpu_torch.ops import extract_kernels as ek
from mgard_tpu_torch.ops import lpk_kernels as lk
from mgard_tpu_torch.ops import stencil_kernels as sk
from mgard_tpu_torch.ops import tridiag as td

CARD = torch.device("cuda", 1)
OTHER = torch.device("cuda", 0)
# The smallest 3-D grid at whose finest level every gate (GPK, LPK,
# extract) admits the kernels.
SHAPE = (16, 128, 128)
C = 8


class FakeCuda:
    """A CPU tensor that reports a CUDA device."""

    is_cuda = True

    def __init__(self, t: torch.Tensor, device):
        self.t = t.contiguous()
        self.device = torch.device(device)

    dtype = property(lambda self: self.t.dtype)
    shape = property(lambda self: self.t.shape)

    def numel(self):
        return self.t.numel()

    def dim(self):
        return self.t.dim()

    def data_ptr(self):
        return self.t.data_ptr()

    def is_contiguous(self):
        return True

    def contiguous(self):
        return self

    def reshape(self, *shape):
        return FakeCuda(self.t.reshape(*shape), self.device)

    def movedim(self, source, destination):
        return FakeCuda(self.t.movedim(source, destination), self.device)

    def __getitem__(self, idx):
        return FakeCuda(self.t[idx], self.device)


def _fake(device, t):
    return FakeCuda(t, device) if torch.device(device).type == "cuda" else t


@pytest.fixture
def card(monkeypatch):
    """Recorders for the launches, the device guard and the streams, and
    tensor factories that keep CUDA tensors fake."""
    calls = []
    guard = []
    asked = []

    class Lib:
        def __getattr__(self, name):
            def launcher(*args):
                calls.append((name, args, guard[-1] if guard else None))
                return 0
            return launcher

    @contextlib.contextmanager
    def device(dev):
        guard.append(torch.device(dev))
        try:
            yield
        finally:
            guard.pop()

    def current_stream(dev=None):
        asked.append(torch.device(dev))
        return type("S", (), {"cuda_stream": 1000 + torch.device(dev).index})

    def factory(real):
        def make(*args, device=None, **kw):
            if device is not None and torch.device(device).type == "cuda":
                return FakeCuda(real(*args, **kw), device)
            return real(*args, device=device, **kw)
        return make

    def like(real):
        def make(t, *args, **kw):
            if isinstance(t, FakeCuda):
                return FakeCuda(real(t.t, *args, **kw), t.device)
            return real(t, *args, **kw)
        return make

    monkeypatch.setattr(_build, "lib", lambda: Lib())
    monkeypatch.setattr(td, "_upload", lambda t, device: _fake(device, t))
    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", current_stream)
    for name in ("empty", "zeros", "as_tensor"):
        monkeypatch.setattr(torch, name, factory(getattr(torch, name)))
    monkeypatch.setattr(torch, "empty_like", like(torch.empty_like))
    _build.reset_launches()
    return calls, asked


def _t(shape, dtype=torch.float32, device=CARD):
    return FakeCuda(torch.zeros(shape, dtype=dtype), device)


def _every_wrapper(dev):
    """Call each of the 18 counted wrappers once with tensors on
    ``dev``."""
    hier = mt.Hierarchy(SHAPE)
    L = hier.L
    seg = _t(32 * C * 2, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    off, e = _t(2, **i32), _t(2, **i32)
    words = _t(33 * 2 * C, **i32)
    z = _t((2, 32, C), **i32)
    core = _t((2, 32, 128), **i32)
    A = _t(hier.shapes[L], device=dev)
    Cc = _t(hier.shapes[L - 1], device=dev)
    V0 = _t(sk._v0_shape(hier, L), device=dev)
    bk.bp_quant_max(seg, 2, C, 1.0)
    bk.bp_quant_condense(seg, 2, C, 1.0, off, e, words)
    bk.bp_decode_condense_f32(words, C, off, e, 1.0, seg.numel())
    bk.bp_encode_condense(z, off, e, words)
    bk.bp_decode_condense(words, C, off, e, seg.numel())
    bk.bp_quant_zigzag(seg, 2, C, 1.0)
    bk.bp_condense_into(z, off, e, words)
    bk.bp_encode_core(core)
    bk.bp_decode_core(core, _t((2, 128), **i32))
    ek.extract_coarse_3d(hier, A, L)
    sk.gpk_detail(hier, A, L)
    sk.gpk_prolong_add(hier, Cc, A, L)
    sk.run_b20(hier, A, L)
    sk.run_b1sub(hier, A, A, L)
    sk.run_dec_b20(hier, Cc, L)
    sk.run_dec_b1add(hier, V0, A, L)
    lk.rm_dim0(hier, A, L)
    lev = hier.dims[1][L]
    td.mass_solve(A, lev.offdiag, lev.divisors, 1)


def test_every_wrapper_launches_on_its_tensors_device(card):
    calls, asked = card
    assert sk._FUSED, "the one-pass GPK wrappers are the default"
    _every_wrapper(CARD)
    assert _build.launch_counts() == {fn.__name__: 1
                                      for fn in _build._wrappers}
    assert len(_build._wrappers) == 18 and len(calls) == 18
    for name, args, under in calls:
        assert under == CARD, name
        assert args[-1] == 1000 + CARD.index, name   # cuda:1's stream
    assert asked == [CARD] * 18


def test_a_second_device_launches_there(card):
    calls, asked = card
    bk.bp_quant_max_segments([_t(32 * C, device=OTHER)] * 3, [1] * 3, C,
                             1.0)
    assert [(n, under) for n, _, under in calls] \
        == [("mgard_bp_quant_max_segments", OTHER)]
    assert asked == [OTHER]


def test_tensors_on_two_devices_raise(card):
    calls, _ = card
    hier = mt.Hierarchy(SHAPE)
    L = hier.L
    seg = _t(32 * C * 2)
    i32 = dict(dtype=torch.int32)
    off, e = _t(2, **i32), _t(2, **i32)
    with pytest.raises(ValueError, match="one CUDA device"):
        bk.bp_quant_max_segments([seg, _t(32 * C * 2, device=OTHER)],
                                 [2, 2], C, 1.0)
    with pytest.raises(ValueError, match="one CUDA device"):
        bk.bp_quant_condense(seg, 2, C, 1.0, off, e,
                             _t(33 * 2 * C, device=OTHER, **i32))
    with pytest.raises(ValueError, match="one CUDA device"):
        bk.bp_decode_condense(_t(33 * 2 * C, device=OTHER, **i32), C, off,
                              e, 10)
    with pytest.raises(ValueError, match="one CUDA device"):
        sk.gpk_prolong_add(hier, _t(hier.shapes[L - 1], device=OTHER),
                           _t(hier.shapes[L]), L)
    with pytest.raises(ValueError, match="one CUDA device"):
        sk.run_b1sub(hier, _t(hier.shapes[L], device=OTHER),
                     _t(hier.shapes[L]), L)
    assert not calls


def test_launch_guards_the_device_and_raises_on_error(card, monkeypatch):
    calls, asked = card
    _build.launch("mgard_anything", 7, 8, device=torch.device("cuda", 2))
    assert calls == [("mgard_anything", (7, 8, 1002), torch.device("cuda",
                                                                  2))]
    assert asked == [torch.device("cuda", 2)]

    class Refused:
        def __getattr__(self, name):
            return lambda *args: 9

    monkeypatch.setattr(_build, "lib", lambda: Refused())
    with pytest.raises(RuntimeError, match="cudaError_t 9"):
        _build.launch("mgard_anything", device=CARD)


def test_device_of():
    assert _build.device_of("k", _t(3), _t(4)) == CARD
    for tensors in ((_t(3), _t(3, device=OTHER)), (torch.zeros(3),),
                    (_t(3), torch.zeros(3)), ()):
        with pytest.raises(ValueError, match="one CUDA device"):
            _build.device_of("k", *tensors)


def test_cpu_tensors_take_the_plain_versions(card):
    """A CPU tensor never reaches a launcher."""
    calls, _ = card
    seg = torch.from_numpy(np.arange(64 * C, dtype=np.float32))
    zmax, status = bk.bp_quant_max(seg, 2, C, 1.0)
    assert zmax.device.type == "cpu" and not calls
    assert _build.launch_counts()["bp_quant_max"] == 0
    lev = mt.Hierarchy((9,)).dims[0][3]
    x = td.mass_solve(torch.ones(9), lev.offdiag, lev.divisors, 0)
    assert x.device.type == "cpu" and not calls
    assert _build.launch_counts()["mass_solve"] == 0
