"""The port's public surface against ``mgard_tpu``'s, on the CPU.

For every module of ``mgard_tpu/``, read by ``ast``, each public
top-level name and each public method of a public class has its
counterpart under the same module path of ``mgard_tpu_torch/``, or an
entry in ``RENAMED``/``UNPORTED`` with its reason.  Then the last names
ported are held against the JAX functions: ``bitplane.encoded_nbytes``
and ``quantize.quantize_pyramid`` on one seeded pyramid at s = inf and
s = 0, and ``Compressor.device_encode_fn``/``device_decode_fn`` against
the JAX methods: the streams bit for bit on one pyramid, and each
package's decoder on the other's stream.
"""

import ast
import importlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mgard_tpu.config import Config as JConfig, Lossless as JLossless
from mgard_tpu.hierarchy import Hierarchy as JHierarchy
from mgard_tpu.ops import bitplane as jbp
from mgard_tpu.ops import quantize as jq
from mgard_tpu.models.compressor import get_compressor as jget
from mgard_tpu.ops import transform as jt

import mgard_tpu_torch as mt
from mgard_tpu_torch.hierarchy import Hierarchy
from mgard_tpu_torch.models.compressor import get_compressor
from mgard_tpu_torch.ops import bitplane, quantize
from mgard_tpu_torch.ops import transform as tt

from test_torch_flat_e2e import _field

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "mgard_tpu"

# JAX module -> the port's module of another name, with the reason
RENAMED = {
    "ops/pallas_kernels.py": ("ops/bp_kernels.py",
                              "the Pallas codec kernels are CUDA in "
                              "csrc/bp_codec.cu, wrapped there"),
}
# (JAX module, name) -> why the port has no counterpart
UNPORTED = {
    ("ops/pallas_kernels.py", "BP_R"): "the Pallas tile's sublane rows "
                                       "(VMEM); the CUDA kernels take 32 "
                                       "words a thread",
}


def _public(path: Path):
    """Public top-level names of a module's source, and ``Class.method``
    for each public method of a public class."""
    out = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef):
            out.append(node.name)
            out += [f"{node.name}.{sub.name}" for sub in node.body
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef))
                    and not sub.name.startswith("_")]
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name):
            out.append(node.target.id)
    return [n for n in out if not n.split(".")[0].startswith("_")]


MODULES = sorted(str(p.relative_to(JAX_PKG))
                 for p in JAX_PKG.rglob("*.py"))


def test_every_module_is_listed():
    assert len(MODULES) >= 40 and "ops/stencil.py" in MODULES \
        and "utils/cache.py" in MODULES


@pytest.mark.parametrize("rel", MODULES)
def test_public_names_have_counterparts(rel):
    names = _public(JAX_PKG / rel)
    port_rel = RENAMED.get(rel, (rel,))[0]
    assert (ROOT / "mgard_tpu_torch" / port_rel).exists(), port_rel
    if not names:
        return          # __main__ and the package markers define nothing
    parts = Path(port_rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    mod = importlib.import_module(".".join(("mgard_tpu_torch",) + parts))
    missing = []
    for name in names:
        if (rel, name) in UNPORTED:
            continue
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part, None)
        if obj is None:
            missing.append(name)
    assert not missing, f"{rel}: no counterpart in {port_rel}: {missing}"


def test_maps_name_what_exists():
    """Every map entry names a JAX module and name that exist, and no
    unported name is in fact in the port."""
    for rel, (port_rel, reason) in RENAMED.items():
        assert (JAX_PKG / rel).exists() and reason
        assert not (ROOT / "mgard_tpu_torch" / rel).exists()
    for (rel, name), reason in UNPORTED.items():
        assert name in _public(JAX_PKG / rel) and reason
        port_rel = RENAMED.get(rel, (rel,))[0]
        mod = importlib.import_module(
            "mgard_tpu_torch." + port_rel[:-3].replace("/", "."))
        assert not hasattr(mod, name)


# ---------------------------------------------------------------------------
# the last names ported, against the JAX functions
# ---------------------------------------------------------------------------

SHAPE = (17, 17, 17)


@pytest.mark.parametrize("s", [math.inf, 0.0])
def test_quantize_pyramid_and_encoded_nbytes(s):
    """One seeded JAX pyramid, quantized by each package: the integers
    bit for bit (int32 by default, int64 on request); their chunked
    streams' payload bytes alike."""
    v = _field(SHAPE, np.float32, 4)
    jh, th = JHierarchy(SHAPE), Hierarchy(SHAPE)
    pyr = [np.array(b) for b in jt.decompose(jh, jnp.asarray(v))]
    tol = 1e-3
    ref = [np.asarray(q) for q in
           jq.quantize_pyramid(jh, [jnp.asarray(b) for b in pyr], s, tol)]
    got = quantize.quantize_pyramid(th, [torch.from_numpy(b) for b in pyr],
                                    s, tol)
    assert [g.dtype for g in got] == [torch.int32] * len(pyr)
    for g, r in zip(got, ref):
        assert r.dtype == np.int32
        assert np.array_equal(g.numpy(), r)
    wide = quantize.quantize_pyramid(th, [torch.from_numpy(b) for b in pyr],
                                     s, tol, torch.int64)
    assert all(w.dtype == torch.int64 and torch.equal(w, g.long())
               for w, g in zip(wide, got))

    flat = np.concatenate([r.ravel() for r in ref])
    je, jw, jc = jbp.encode(jnp.asarray(flat))
    te, tw, tc = bitplane.encode(torch.from_numpy(flat))
    nbytes = jbp.encoded_nbytes(je, jc)
    assert bitplane.encoded_nbytes(te, tc) == nbytes
    assert bitplane.encoded_nbytes(np.asarray(je), int(jc)) == nbytes
    assert nbytes == int(np.asarray(je).size) + 4 * int(jc) > 0


CONFIGS = [(np.float32, mt.Config()),
           (np.float32, mt.Config(adapt_lossless=False)),
           (np.float32, mt.Config(lossless=mt.Lossless.BITPLANE_GROUP)),
           (np.float32, mt.Config(lossless=mt.Lossless.HUFFMAN_ZLIB)),
           (np.float64, mt.Config())]


def _jax_config(config):
    return JConfig(lossless=JLossless(int(config.lossless)),
                   adapt_lossless=config.adapt_lossless)


@pytest.mark.parametrize("dtype,config", CONFIGS,
                         ids=lambda c: getattr(c, "__name__", None)
                         or c.lossless.name + ("" if c.adapt_lossless
                                               else "-fixed"))
def test_device_fns_round_trip(dtype, config, monkeypatch):
    """``device_encode_fn`` gives ``encode_device``'s four tensors (the
    bitplane stream also for a host lossless) and, on the same pyramid,
    the JAX ``device_encode_fn``'s four bit for bit; ``device_decode_fn``
    brings the port's stream and the JAX one back within the tolerance,
    and the JAX ``device_decode_fn`` the port's."""
    v = _field(SHAPE, dtype, 5)
    tol = 1e-3
    # the float32 transforms differ by an ulp on XLA's CPU, and an ulp
    # can move an integer across a rounding edge: both packages quantize
    # the JAX pyramid, as tests/test_torch_flat.py's stream checks do
    pyr = [np.array(p) for p in jax.jit(
        lambda a: jt.decompose(JHierarchy(SHAPE), a))(jnp.asarray(v))]
    monkeypatch.setattr(jt, "decompose",
                        lambda hier, x: [jnp.asarray(p) for p in pyr])
    monkeypatch.setattr(tt, "decompose",
                        lambda hier, x: [torch.from_numpy(p) for p in pyr])

    comp = get_compressor(SHAPE, dtype, config=config, device="cpu")
    jcomp = jget(SHAPE, dtype, config=_jax_config(config))
    enc, dec = comp.device_encode_fn(), comp.device_decode_fn()
    out = enc(torch.from_numpy(v), tol)
    assert len(out) == 4
    exponents, words, count, status = out
    assert int(status) == 0
    if config.lossless is mt.Lossless.HUFFMAN_ZLIB:
        assert comp._codec(comp.lossless) == "chunked"
    else:
        for a, b in zip(out, comp.encode_device(torch.from_numpy(v), tol)):
            assert torch.equal(a, b)

    # the port keeps words as int32 and the count as int64 where JAX has
    # uint32 and int32: the same bits and the same values.  The port's
    # quanta are those JAX traces for a float32 tolerance on the segmented
    # stream (tests/test_torch_codec.py) and under x64 on the flat ones
    # (tests/test_torch_flat.py): JAX gets the tolerance so
    jtol = np.float32(tol) if comp._codec(comp.lossless) == "segmented" \
        else tol
    jout = jax.jit(jcomp.device_encode_fn())(jnp.asarray(v), jtol)
    je, jw, jn, js = (np.array(x) for x in jout)
    assert np.array_equal(exponents.numpy(), je)
    assert words.dtype == torch.int32 and jw.dtype == np.uint32
    assert np.array_equal(words.numpy().view(np.uint32), jw)
    assert int(count) == int(jn) and int(status) == int(js) == 0

    back = dec(exponents, words, torch.tensor(tol))
    assert back.dtype == torch.from_numpy(v).dtype and back.shape == SHAPE
    assert float(np.abs(back.numpy() - v).max()) <= tol
    from_jax = dec(torch.from_numpy(je), torch.from_numpy(jw.view(np.int32)),
                   tol)
    assert float(np.abs(from_jax.numpy() - v).max()) <= tol
    jback = jax.jit(jcomp.device_decode_fn())(
        jnp.asarray(exponents.numpy()),
        jnp.asarray(words.numpy().view(np.uint32)), jtol)
    assert float(np.abs(np.asarray(jback) - v).max()) <= tol
