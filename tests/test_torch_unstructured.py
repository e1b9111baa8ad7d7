"""mgard_tpu_torch's unstructured meshes against mgard_tpu's, on the CPU.

Meshes (nodes, elements, edge parents) are the JAX package's exactly; the
measures and the mass operators agree within 1e-14 relative (an explicit
determinant against LAPACK's, sums in the same order); the CG solves take
the same iteration counts as JAX's ``cg`` loop and agree within 1e-12;
the transform, norms and estimator within a float64 bound; quantizing the
same coefficients gives the same integer stream and the same codec bytes;
MGTU buffers decode in both packages within the s-norm bound.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mgard_tpu.unstructured as J
from mgard_tpu.ops import bitplane as jbp
from mgard_tpu.unstructured import hierarchy as jhier
from mgard_tpu.unstructured import mesh as jmesh

import mgard_tpu_torch.unstructured as P
from mgard_tpu_torch.ops import bitplane as tbp
from mgard_tpu_torch.unstructured import hierarchy as phier
from mgard_tpu_torch.unstructured import mesh as pmesh

# the modules (the packages export functions of the same name)
jcompress = importlib.import_module("mgard_tpu.unstructured.compress")
pcompress = importlib.import_module("mgard_tpu_torch.unstructured.compress")

CPU = "cpu"
# Mass operators, measures: relative to the largest value.
OP_RTOL = 1e-14
# CG solutions (tol 1e-9) reached by the same iterates in another
# summation order.
CG_RTOL = 1e-12
# Coefficients, recomposed values, norms and estimators: relative to the
# largest value (or the norm).
TRANSFORM_RTOL = 1e-11

MESHES = {
    "tri(3,3) L=3": (lambda: J.structured_triangle_mesh(3, 3),
                     lambda: P.structured_triangle_mesh(3, 3, device=CPU),
                     3),
    "tet(2,2,2) L=2": (lambda: J.structured_tet_mesh((2, 2, 2)),
                       lambda: P.structured_tet_mesh((2, 2, 2), device=CPU),
                       2),
    "tet(3,3,3) L=2": (lambda: J.structured_tet_mesh((3, 3, 3)),
                       lambda: P.structured_tet_mesh((3, 3, 3), device=CPU),
                       2),
}
_CACHE = {}


def _pair(name):
    """(JAX hierarchy, port hierarchy), built once a module."""
    if name not in _CACHE:
        jroot, proot, L = MESHES[name]
        _CACHE[name] = (J.UniformMeshHierarchy(jroot(), L),
                        P.UniformMeshHierarchy(proot(), L))
    return _CACHE[name]


def _jax_coeffs(name):
    """(field, JAX's coefficients of it), computed once a module: each
    JAX ``decompose`` call compiles anew."""
    key = ("coeffs", name)
    if key not in _CACHE:
        jh, _ = _pair(name)
        u = _field(jh, 7)
        _CACHE[key] = (u, np.asarray(jh.decompose(u)))
    return _CACHE[key]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-300))


def _field(hier, seed):
    """A smooth function of the finest nodes plus seeded noise (numpy)."""
    x = np.asarray(hier.meshes[-1].nodes)
    u = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1]) + 0.3 * x[:, 0] * x[:, 1]
    return u + 0.01 * np.random.default_rng(seed).standard_normal(len(u))


@pytest.mark.parametrize("name", list(MESHES))
def test_meshes_equal_the_jax_meshes(name):
    jh, ph = _pair(name)
    for jm, pm in zip(jh.meshes, ph.meshes):
        assert pm.nodes.device.type == CPU
        np.testing.assert_array_equal(pm.nodes.numpy(), jm.nodes)
        np.testing.assert_array_equal(pm.elements.numpy(), jm.elements)
        if jm.edge_parents is None:
            assert pm.edge_parents is None
        else:
            np.testing.assert_array_equal(pm.edge_parents.numpy(),
                                          jm.edge_parents)
        assert (pm.ndof, pm.dim) == (jm.ndof, jm.dim)


@pytest.mark.parametrize("name", list(MESHES))
def test_mass_operators(name):
    jh, ph = _pair(name)
    rng = np.random.default_rng(11)
    for jm, pm in zip(jh.meshes, ph.meshes):
        assert _rel(jm.measures, pm.measures.numpy()) <= OP_RTOL
        assert _rel(jm.mass_diagonal(), pm.mass_diagonal().numpy()) \
            <= OP_RTOL
        assert _rel(jm.containing_elements_measure(),
                    pm.containing_elements_measure().numpy()) <= OP_RTOL
        u = rng.standard_normal(jm.ndof)
        assert _rel(np.asarray(jm.mass_matvec(jnp.asarray(u))),
                    pm.mass_matvec(torch.from_numpy(u)).numpy()) <= OP_RTOL


def test_measures_of_a_triangle_in_space():
    """Triangles with 3-D coordinates (a .msh surface) take the cross
    product's length."""
    nodes = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 0], [0, 0, 3.0]])
    elements = np.array([[0, 1, 2], [1, 2, 3]])
    jm = jmesh.MeshLevel(nodes, elements)
    pm = pmesh.MeshLevel(nodes, elements, device=CPU)
    assert _rel(jm.measures, pm.measures.numpy()) <= OP_RTOL
    assert _rel(jm.mass_diagonal(), pm.mass_diagonal().numpy()) <= OP_RTOL


def _jax_cg(mesh, b, tol=1e-9, maxiter=400):
    """``jax.scipy.sparse.linalg.cg``'s loop (its ``_cg_solve``) as the
    JAX hierarchy calls it, also returning its iteration count."""
    dinv = jnp.asarray(1.0 / mesh.mass_diagonal(), dtype=b.dtype)
    A = mesh.mass_matvec
    atol2 = jnp.maximum(jnp.square(tol) * jnp.vdot(b, b), 0.0)

    def cond(v):
        _, r, _, _, k = v
        return (jnp.vdot(r, r) > atol2) & (k < maxiter)

    def body(v):
        x, r, gamma, p, k = v
        Ap = A(p)
        alpha = gamma / jnp.vdot(p, Ap)
        r_ = r - alpha * Ap
        z_ = dinv * r_
        gamma_ = jnp.vdot(r_, z_)
        return (x + alpha * p, r_, gamma_, z_ + (gamma_ / gamma) * p, k + 1)

    r0 = b - A(jnp.zeros_like(b))
    z0 = dinv * r0
    x, _, _, _, k = jax.lax.while_loop(
        cond, body, (jnp.zeros_like(b), r0, jnp.vdot(r0, z0), z0, 0))
    return x, int(k)


@pytest.mark.parametrize("name", ["tri(3,3) L=3", "tet(3,3,3) L=2"])
def test_cg_iterations_and_solutions(name):
    """The port's blocked, masked CG takes JAX's iteration count and
    reaches its solution; the test's copy of JAX's loop is JAX's ``cg``
    itself."""
    jh, ph = _pair(name)
    rng = np.random.default_rng(5)
    counts = []
    for l in range(jh.L + 1):
        b = rng.standard_normal(jh.ndof(l))
        xj, kj = _jax_cg(jh.meshes[l], jnp.asarray(b))
        if l == jh.L:
            np.testing.assert_array_equal(
                np.asarray(jhier._cg_solve(jh.meshes[l], jnp.asarray(b))),
                np.asarray(xj))
        xp, kp = phier.cg_solve(ph.meshes[l], torch.from_numpy(b))
        assert kp == kj
        assert _rel(xj, xp.numpy()) <= CG_RTOL
        counts.append(kp)
    # the finer solves stop in a later block than the first
    assert max(counts) > phier.CG_BLOCK
    # maxiter stops the blocks inside a block
    xp, kp = phier.cg_solve(ph.meshes[-1], torch.from_numpy(
        rng.standard_normal(ph.ndof())), maxiter=3)
    assert kp == 3


@pytest.mark.parametrize("name", ["tri(3,3) L=3", "tet(3,3,3) L=2"])
def test_transform_norms_estimator(name):
    jh, ph = _pair(name)
    u, cj = _jax_coeffs(name)
    cp = ph.decompose(u)
    assert cp.dtype == torch.float64 and cp.device.type == CPU
    assert _rel(cj, cp.numpy()) <= TRANSFORM_RTOL
    assert set(ph.cg_iterations) == set(range(ph.L))
    assert _rel(np.asarray(jh.recompose(cj)),
                ph.recompose(torch.from_numpy(cj.copy())).numpy()) \
        <= TRANSFORM_RTOL
    np.testing.assert_allclose(ph.recompose(cp).numpy(), u, atol=1e-7)
    for s in (0.0, 0.5, math.inf):
        assert abs(ph.norm(u, s) - jh.norm(u, s)) \
            <= TRANSFORM_RTOL * jh.norm(u, s)
    for s in (0.0, 0.5):
        assert abs(ph.estimator(cp, s) - jh.estimator(cj, s)) \
            <= TRANSFORM_RTOL * jh.estimator(cj, s)
    assert ph.estimator_bounds(0.5) == jh.estimator_bounds(0.5)
    assert ph.indicator_bounds() == jh.indicator_bounds()
    with pytest.raises(ValueError):
        ph.estimator(cp, math.inf)
    with pytest.raises(ValueError):
        ph.decompose(u[:-1])


def test_linear_function_has_zero_details():
    ph = P.UniformMeshHierarchy(
        P.structured_triangle_mesh(3, 3, device=CPU), 2)
    x = ph.meshes[-1].nodes
    coeffs = ph.decompose(2.0 * x[:, 0] - 0.5 * x[:, 1] + 1.0)
    assert float(coeffs[ph.ndof(0):].abs().max()) < 1e-8


@pytest.mark.parametrize("name,s,tol", [("tri(3,3) L=3", 0.0, 1e-2),
                                        ("tet(3,3,3) L=2", 1.0, 5e-2)])
def test_integer_streams_and_codec_bytes(name, s, tol):
    """The quanta agree within 1e-14 (they are built from the measures);
    rounding the same scaled coefficients gives the same int32 stream,
    and coding the same stream the same per-group exponents and words,
    bit for bit; the port's own stream differs from JAX's by at most one
    quantum, and only where a scaled coefficient lies within 1e-9 of a
    rounding boundary."""
    jh, ph = _pair(name)
    u, cj = _jax_coeffs(name)
    qj = jcompress._quanta(jh, s, tol)
    qp = pcompress._quanta(ph, s, tol)
    assert _rel(qj, qp.numpy()) <= OP_RTOL

    def jround(x):
        return np.asarray(jnp.trunc(jnp.copysign(0.5 + jnp.abs(x), x)
                                    ).astype(jnp.int32))

    def tround(x):
        return torch.trunc(torch.copysign(0.5 + x.abs(), x)).to(torch.int32)

    scaled = cj / qj
    ints_j = jround(scaled)
    np.testing.assert_array_equal(tround(torch.from_numpy(scaled)).numpy(),
                                  ints_j)
    ints_p = tround(ph.decompose(u) / qp).numpy()
    off = ints_p != ints_j
    assert np.abs(ints_p.astype(np.int64) - ints_j).max() <= 1
    assert np.all(np.abs(np.abs(scaled[off]) % 1.0 - 0.5) < 1e-9)
    ej, wj, nj = jbp.encode_pergroup(jnp.asarray(ints_j))
    ep, wp, np_ = tbp.encode_pergroup(torch.from_numpy(ints_j))
    assert int(nj) == int(np_) > 0
    np.testing.assert_array_equal(ep.numpy(), np.asarray(ej))
    np.testing.assert_array_equal(
        wp.numpy()[:int(np_)].view(np.uint32), np.asarray(wj)[:int(nj)])


@pytest.mark.parametrize("name,s,tol", [("tri(3,3) L=3", 1.0, 5e-2),
                                        ("tet(2,2,2) L=2", 0.0, 1e-2),
                                        ("tet(3,3,3) L=2", 0.0, 1e-3)])
def test_mgtu_cross_decodes(name, s, tol):
    """Each package decodes the other's buffer within the s-norm bound,
    measured by the port's norm (held to JAX's above; JAX's s-norm
    compiles a CG loop a level at each call)."""
    jh, ph = _pair(name)
    u = _field(jh, 9)
    bj = J.compress(jh, u, s=s, tolerance=tol)
    bp = P.compress(ph, u, s, tol)
    assert bp[:4] == b"MGTU" and len(bp) < u.nbytes
    for buf in (bj, bp):
        for out in (np.asarray(J.decompress(jh, buf)),
                    P.decompress(ph, buf)):
            assert out.dtype == np.float64 and out.shape == u.shape
            assert ph.norm(u - out, s) <= tol


def test_compress_refusals():
    ph = P.UniformMeshHierarchy(
        P.structured_triangle_mesh(3, 3, device=CPU), 1)
    u = np.zeros(ph.ndof())
    with pytest.raises(ValueError):
        P.compress(ph, u, math.inf, 0.1)
    with pytest.raises(OverflowError):
        P.compress(ph, u + 1e6, 0.0, 1e-9)
    buf = P.compress(ph, u, 0.0, 0.1)
    with pytest.raises(ValueError, match="not an unstructured"):
        P.decompress(ph, b"XXXX" + buf[4:])
    other = P.UniformMeshHierarchy(
        P.structured_triangle_mesh(3, 3, device=CPU), 2)
    with pytest.raises(ValueError, match="dof mismatch"):
        P.decompress(other, buf)


_TRI = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
_TET = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                 [0.0, 0.0, 1.0]])


def _round_trip(pkg, mesh, L):
    """A hierarchy of ``L`` refinements of ``mesh``, then compress and
    decompress of a ramp on it (s = 0, tolerance 0.1)."""
    h = pkg.UniformMeshHierarchy(mesh, L)
    u = np.linspace(0.0, 1.0, h.ndof())
    if pkg is J:
        return J.decompress(h, J.compress(h, u, s=0.0, tolerance=0.1))
    return P.decompress(h, P.compress(h, u, 0.0, 0.1))


# (JAX call, port call, the exception both raise: None where both accept)
REFUSALS = {
    **{f"tri{n}": (lambda n=n: J.structured_triangle_mesh(*n),
                   lambda n=n: P.structured_triangle_mesh(*n, device=CPU),
                   ValueError)
       for n in ((2, 1), (1, 1), (1, 2), (0, 3))},
    **{f"tet{n}": (lambda n=n: J.structured_tet_mesh(n),
                   lambda n=n: P.structured_tet_mesh(n, device=CPU),
                   ValueError)
       for n in ((1, 2, 3), (2, 2, 1), (0, 2, 2))},
    **{f"empty (0, {k}) round trip": (
        lambda k=k, x=x: _round_trip(
            J, J.MeshLevel(x, np.zeros((0, k), np.int64)), 1),
        lambda k=k, x=x: _round_trip(
            P, P.MeshLevel(x, np.zeros((0, k), np.int64), device=CPU), 1),
        ValueError) for k, x in ((3, _TRI), (4, _TET))},
    "empty (0, 3) level": (
        lambda: J.MeshLevel(_TRI, np.zeros((0, 3), np.int64)),
        lambda: P.MeshLevel(_TRI, np.zeros((0, 3), np.int64), device=CPU),
        None),
    # JAX wraps -1 to the last node, leaves a node of no element after two
    # refinements and fails on the NaN quanta; the port refuses the index
    "negative index round trip": (
        lambda: _round_trip(J, J.MeshLevel(_TRI, [[0, 1, -1]]), 2),
        lambda: _round_trip(P, P.MeshLevel(_TRI, [[0, 1, -1]], device=CPU),
                            2),
        ValueError),
}


def _raised(call):
    try:
        call()
    except Exception as e:      # the type is what the test compares
        return type(e)
    return None


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_match_jax(case):
    """Both packages raise the same exception type on the same call (or
    both accept it): a mesh with no elements is refused before compress
    can return a buffer for it."""
    jax_call, port_call, want = REFUSALS[case]
    assert _raised(jax_call) is want
    assert _raised(port_call) is want


def test_entry_points_need_a_card_or_the_cpu():
    """Without a card, a mesh asked for without device='cpu' raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        P.structured_tet_mesh((2, 2, 2))


def _write_msh(path):
    """A Gmsh 2.2 file: a unit square of two triangles, with a boundary
    line and unused node 9."""
    path.write_text("\n".join([
        "$MeshFormat", "2.2 0 8", "$EndMeshFormat",
        "$Nodes", "5",
        "1 0 0 0", "2 1 0 0", "3 1 1 0", "4 0 1 0", "9 5 5 5",
        "$EndNodes",
        "$Elements", "3",
        "1 1 2 1 1 1 2",
        "2 2 2 0 1 1 2 3",
        "3 2 2 0 1 1 3 4",
        "$EndElements", ""]))


def test_load_msh(tmp_path):
    path = tmp_path / "square.msh"
    _write_msh(path)
    jm = jmesh.load_msh(path)
    pm = pmesh.load_msh(path, device=CPU)
    np.testing.assert_array_equal(pm.nodes.numpy(), jm.nodes)
    np.testing.assert_array_equal(pm.elements.numpy(), jm.elements)
    assert pm.ndof == 4 and pm.dim == 2
    assert abs(float(pm.measures.sum()) - 1.0) < 1e-15
    (tmp_path / "empty.msh").write_text("$Nodes\n0\n$EndNodes\n")
    with pytest.raises(ValueError, match="no triangles"):
        pmesh.load_msh(tmp_path / "empty.msh", device=CPU)
