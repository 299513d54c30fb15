"""Unit tests for quadrature, basis tabulation and batched element kernels."""

import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.elements.basis import DEFAULT_NGP, tabulate_basis
from pfemfort_jax.elements.elasticity import (
    dmat_3d,
    dmat_plane_strain,
    dmat_plane_stress,
    elasticity_residual,
    elasticity_stiffness,
    lumped_mass,
)
from pfemfort_jax.elements.geometry import grads_and_det, to_element_minor


def _em(coords):
    return jnp.asarray(to_element_minor(np.asarray(coords, dtype=float)))


def _K_np(K):
    """(ns, ns, E) device K -> (E, ns, ns) numpy for oracle comparison."""
    return np.asarray(K).transpose(2, 0, 1)


def _F_np(F):
    return np.asarray(F).T
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.elements.quadrature import gauss_rule

ALL_ETYPES = ["tria3", "tria6", "quad4", "tetra4", "prism6", "hexa8"]

# total weight = reference volume of each parametric element
_REF_VOLUME = {"tria": 0.5, "tetra": 1 / 6, "quad": 4.0, "hexa": 8.0,
               "prism": 1.0, "line": 2.0}

_RULES = {
    "line": [1, 2, 3, 4, 5, 6, 7, 8],
    "tria": [1, 3, 4, 6, 7],
    "tetra": [1, 4, 5],
    "quad": [1, 4, 9, 16, 25],
    "hexa": [1, 8, 27],
    "prism": [1, 2, 3, 6],
}


@pytest.mark.parametrize("shape", list(_RULES))
def test_quadrature_weights_sum(shape):
    for ngp in _RULES[shape]:
        pts, wts = gauss_rule(shape, ngp)
        assert pts.shape[0] == ngp
        assert np.isclose(wts.sum(), _REF_VOLUME[shape]), (shape, ngp)


def test_tria_rule_exactness():
    # 3-pt rule integrates quadratics exactly over the unit triangle
    pts, wts = gauss_rule("tria", 3)
    x, y = pts[:, 0], pts[:, 1]
    assert np.isclose((wts * x * y).sum(), 1 / 24)
    assert np.isclose((wts * x * x).sum(), 1 / 12)


def test_tetra_rule_exactness():
    pts, wts = gauss_rule("tetra", 4)
    x = pts[:, 0]
    assert np.isclose((wts * x).sum(), 1 / 24)   # int x over unit tet
    assert np.isclose((wts * x * x).sum(), 1 / 60)


@pytest.mark.parametrize("etype", ALL_ETYPES)
def test_partition_of_unity(etype):
    pts, wts, N, dNdu = tabulate_basis(etype)
    assert np.allclose(N.sum(axis=1), 1.0)
    assert np.allclose(dNdu.sum(axis=2), 0.0, atol=1e-14)


@pytest.mark.parametrize("etype", ALL_ETYPES)
def test_linear_completeness(etype):
    """sum_i N_i(xi) * x_i == x for the element's own node coords."""
    nodes = _reference_nodes(etype)
    pts, wts, N, dNdu = tabulate_basis(etype)
    interp = N @ nodes  # (G, pdim)
    if etype == "tria6":
        # quadratic basis on the reference's squared-coordinate convention is
        # NOT a standard interpolatory basis at midside nodes; skip identity.
        return
    assert np.allclose(interp, pts, atol=1e-12), (interp, pts)


def _reference_nodes(etype):
    """Parametric node coordinates implied by each basis ordering."""
    if etype == "tria3":
        return np.array([[0, 0], [1, 0], [0, 1]], dtype=float)
    if etype == "tria6":
        return np.array([[0, 0], [1, 0], [0, 1],
                         [0.5, 0], [0.5, 0.5], [0, 0.5]], dtype=float)
    if etype == "quad4":
        return np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=float)
    if etype == "tetra4":
        # N1=xi1, N2=xi2, N3=bubble, N4=xi3 (basisfuncs.F:263-266)
        return np.array([[1, 0, 0], [0, 1, 0], [0, 0, 0], [0, 0, 1]],
                        dtype=float)
    if etype == "prism6":
        return np.array([[0, 0, -1], [1, 0, -1], [0, 1, -1],
                         [0, 0, 1], [1, 0, 1], [0, 1, 1]], dtype=float)
    if etype == "hexa8":
        return np.array([[i, j, k] for k in (-1, 1) for j in (-1, 1)
                         for i in (-1, 1)], dtype=float)
    raise ValueError(etype)


def test_tria3_stiffness_closed_form():
    """Batched Poisson tria3 matches the hand-coded area*B*B^T stiffness the
    serial driver uses (/root/reference/src/triapoissonserialimpl1.F:580-594)."""
    rng = np.random.default_rng(0)
    coords = rng.uniform(size=(20, 3, 2))
    # enforce positive orientation
    x, y = coords[..., 0], coords[..., 1]
    area = 0.5 * (x[:, 1] * y[:, 2] - x[:, 2] * y[:, 1]
                  + x[:, 2] * y[:, 0] - x[:, 0] * y[:, 2]
                  + x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0])
    flip = area < 0
    coords[flip] = coords[flip][:, [0, 2, 1]]

    K, F = poisson_element_matrices(_em(coords), "tria3")
    K = _K_np(K)

    for e in range(coords.shape[0]):
        x1, y1 = coords[e, 0]
        x2, y2 = coords[e, 1]
        x3, y3 = coords[e, 2]
        a = 0.5 * (x2 * y3 - x3 * y2 + x3 * y1 - x1 * y3 + x1 * y2 - x2 * y1)
        B = np.array([[y2 - y3, x3 - x2],
                      [y3 - y1, x1 - x3],
                      [y1 - y2, x2 - x1]]) / (2 * a)
        Kref = a * (B @ B.T)
        assert np.allclose(K[e], Kref, atol=1e-12), e
    assert np.allclose(_F_np(F), 0.0)


def test_tetra4_stiffness_properties():
    rng = np.random.default_rng(1)
    base = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)
    coords = base[None] + 0.05 * rng.standard_normal((10, 4, 3))
    K, F = poisson_element_matrices(_em(coords), "tetra4", source=-6.0)
    K = _K_np(K)
    assert np.allclose(K, np.swapaxes(K, 1, 2), atol=1e-12)   # symmetric
    assert np.allclose(K.sum(axis=2), 0.0, atol=1e-10)        # constant null
    # eigenvalues nonnegative
    w = np.linalg.eigvalsh(K)
    assert (w > -1e-10).all()
    # source integral: F_i = -6 * V / 4 for the unit-ish tet
    V = np.abs(np.linalg.det(coords[:, 1:] - coords[:, :1])) / 6
    assert np.allclose(_F_np(F).sum(axis=1), -6 * V, rtol=1e-10)


def test_elasticity_stiffness_vs_manual():
    """K = B^T D B with the reference's exact B/D (plane stress tria)."""
    rng = np.random.default_rng(2)
    coords = np.array([[[0.0, 0.0], [1.1, 0.1], [0.2, 0.9]]])
    E_, nu = 240.565, 0.3
    D = dmat_plane_stress(E_, nu)
    K, F = elasticity_stiffness(_em(coords), "tria3", D, thickness=1.0)
    K = _K_np(K)[0]

    # manual: 1-pt rule
    x1, y1 = coords[0, 0]
    x2, y2 = coords[0, 1]
    x3, y3 = coords[0, 2]
    a = 0.5 * (x2 * y3 - x3 * y2 + x3 * y1 - x1 * y3 + x1 * y2 - x2 * y1)
    dNdx = np.array([y2 - y3, y3 - y1, y1 - y2]) / (2 * a)
    dNdy = np.array([x3 - x2, x1 - x3, x2 - x1]) / (2 * a)
    B = np.zeros((3, 6))
    for i in range(3):
        B[0, 2 * i] = dNdx[i]
        B[1, 2 * i + 1] = dNdy[i]
        B[2, 2 * i] = dNdy[i]
        B[2, 2 * i + 1] = dNdx[i]
    Kref = a * (B.T @ D @ B)
    assert np.allclose(K, Kref, atol=1e-9)


def test_elasticity_residual_consistency():
    """For the same D, residual(u) == -K u + body force (pure elements).

    The residual uses tensorial shear for the stress while K uses engineering
    B on both sides — for symmetric D these agree: B^T D (S:grad u) == K u
    only when D's shear diagonal absorbs the 1/2.  Here we verify against an
    explicit dense computation instead of assuming.
    """
    coords = np.array([[[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]])
    disp = np.array([[[0.01, 0.0], [0.0, 0.02], [0.005, -0.01]]])
    E_, nu, dens = 200.0, 0.3, 10.0
    D = dmat_plane_strain(E_, nu)
    disp_em = jnp.asarray(disp.reshape(1, 6).T)
    F = np.asarray(elasticity_residual(
        _em(coords), disp_em, "tria3", D, dens, jnp.zeros(2))).T[0]

    # dense check (reference algebra, elasticity2D.F:241-271)
    a = 0.5
    dNdx = np.array([-1.0, 1.0, 0.0])
    dNdy = np.array([-1.0, 0.0, 1.0])
    grad = np.zeros((2, 2))
    for i in range(3):
        grad[0] += disp[0, i, 0] * np.array([dNdx[i], dNdy[i]])
        grad[1] += disp[0, i, 1] * np.array([dNdx[i], dNdy[i]])
    strain = np.array([grad[0, 0], grad[1, 1], 0.5 * (grad[0, 1] + grad[1, 0])])
    stress = D @ strain
    Fref = np.zeros(6)
    for i in range(3):
        b1, b2 = a * dNdx[i], a * dNdy[i]
        Fref[2 * i] = -(b1 * stress[0] + b2 * stress[2])
        Fref[2 * i + 1] = -(b1 * stress[2] + b2 * stress[1])
    assert np.allclose(F, Fref, atol=1e-12)


@pytest.mark.parametrize("etype,ndim", [("tria3", 2), ("tria6", 2),
                                        ("quad4", 2), ("tetra4", 3),
                                        ("prism6", 3)])
def test_lumped_mass_total(etype, ndim):
    """Lumped mass sums to dens * volume per dof component."""
    nodes = _reference_nodes(etype)
    if etype == "tria6":
        # physical tria6: corners of unit triangle + midsides
        nodes = np.array([[0, 0], [1, 0], [0, 1],
                          [0.5, 0], [0.5, 0.5], [0, 0.5]], dtype=float)
    coords = nodes[None].astype(float)
    vol = {"tria3": 0.5, "tria6": 0.5, "quad4": 4.0, "tetra4": 1 / 6,
           "prism6": 1.0}[etype]
    dens = 3.0
    M = np.asarray(lumped_mass(_em(coords), etype, dens, ndim,
                               ngp={"prism6": 2}.get(etype)))
    total = M.sum() / ndim
    assert np.isclose(total, dens * vol, rtol=1e-10)
