"""Value-level oracles for EVERY explicit element kernel.

Independent scalar-loop numpy implementations of the reference's residual /
lumped-mass math (plane-strain tensorial-shear stress, dens*dvol*N*b body
force, row-sum mass; /root/reference/src/elementutilitieselasticity2D.F:
158-362, 367-571, 700-889; elementutilitieselasticity3D.F:24-243, 575-723),
written from the formulas with per-element per-Gauss-point loops — no shared
code with the batched jnp kernels they check.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.dynamics.explicit import _MASS_NGP, explicit_dynamics
from pfemfort_jax.elements.elasticity import (
    dmat_3d,
    dmat_plane_strain,
    dmat_plane_stress,
    elasticity_residual,
    lumped_mass,
    quad_hg_residual,
)
from pfemfort_jax.elements.geometry import to_element_minor
from pfemfort_jax.mesh import generate

# --------------------------------------------------------------------------
# independent basis + quadrature (plain python, per-point)
# --------------------------------------------------------------------------

_G3 = np.sqrt(1.0 / 3.0)


def _rule(etype, ngp):
    """(points, weights) — standard published rules, simplex-normalized."""
    if etype in ("tria3", "tria6"):
        if ngp == 1:
            return [(1 / 3, 1 / 3)], [0.5]
        if ngp == 3:
            return [(1 / 6, 1 / 6), (1 / 6, 4 / 6), (4 / 6, 1 / 6)], [1 / 6] * 3
    if etype == "tetra4" and ngp == 1:
        return [(0.25, 0.25, 0.25)], [1 / 6]
    if etype == "quad4" and ngp == 4:
        return [(-_G3, -_G3), (_G3, -_G3), (-_G3, _G3), (_G3, _G3)], [1.0] * 4
    if etype == "prism6":
        if ngp == 1:
            return [(1 / 3, 1 / 3, 0.0)], [1.0]
        if ngp == 2:
            return [(1 / 3, 1 / 3, -_G3), (1 / 3, 1 / 3, _G3)], [0.5, 0.5]
    if etype == "hexa8" and ngp == 8:
        pts = [(sx * _G3, sy * _G3, sz * _G3)
               for sz in (-1, 1) for sy in (-1, 1) for sx in (-1, 1)]
        return pts, [1.0] * 8
    raise ValueError((etype, ngp))


def _shape(etype, xi):
    """N (npe,), dN/dxi (npe, pdim) — node orders as the reference defines
    them (tetra: N3 = 1-x1-x2-x3; prism: bottom triangle first)."""
    if etype == "tria3":
        a, b = xi
        c = 1 - a - b
        return np.array([c, a, b]), np.array([[-1, -1], [1, 0], [0, 1]],
                                             dtype=float)
    if etype == "tria6":
        a, b = xi
        c = 1 - a - b
        N = np.array([c * c, a * a, b * b, 2 * a * c, 2 * a * b, 2 * b * c])
        dN = np.array([
            [-2 * c, -2 * c],
            [2 * a, 0],
            [0, 2 * b],
            [2 * (c - a), -2 * a],
            [2 * b, 2 * a],
            [-2 * b, 2 * (c - b)],
        ], dtype=float)
        return N, dN
    if etype == "quad4":
        a, b = xi
        N = 0.25 * np.array([(1 - a) * (1 - b), (1 + a) * (1 - b),
                             (1 + a) * (1 + b), (1 - a) * (1 + b)])
        dN = 0.25 * np.array([
            [-(1 - b), -(1 - a)],
            [(1 - b), -(1 + a)],
            [(1 + b), (1 + a)],
            [-(1 + b), (1 - a)],
        ])
        return N, dN
    if etype == "tetra4":
        a, b, c = xi
        N = np.array([a, b, 1 - a - b - c, c])
        dN = np.array([[1, 0, 0], [0, 1, 0], [-1, -1, -1], [0, 0, 1]],
                      dtype=float)
        return N, dN
    if etype == "prism6":
        a, b, z = xi
        c = 1 - a - b
        lo, hi = 0.5 * (1 - z), 0.5 * (1 + z)
        N = np.array([c * lo, a * lo, b * lo, c * hi, a * hi, b * hi])
        dN = np.array([
            [-lo, -lo, -0.5 * c],
            [lo, 0, -0.5 * a],
            [0, lo, -0.5 * b],
            [-hi, -hi, 0.5 * c],
            [hi, 0, 0.5 * a],
            [0, hi, 0.5 * b],
        ])
        return N, dN
    if etype == "hexa8":
        # lattice-bit node order (x fastest), as generate.box_hexa /
        # LagrangeBasisFunsHex (basisfuncs.F:323-330)
        a, b, c = xi
        N = np.zeros(8)
        dN = np.zeros((8, 3))
        for k in range(8):
            s_ = [2 * ((k >> d) & 1) - 1 for d in range(3)]
            f = [(1 + s_[0] * a) / 2, (1 + s_[1] * b) / 2,
                 (1 + s_[2] * c) / 2]
            N[k] = f[0] * f[1] * f[2]
            dN[k, 0] = s_[0] / 2 * f[1] * f[2]
            dN[k, 1] = f[0] * s_[1] / 2 * f[2]
            dN[k, 2] = f[0] * f[1] * s_[2] / 2
        return N, dN
    raise ValueError(etype)


def _voigt(ndim):
    return ([(0, 0), (1, 1), (0, 1)] if ndim == 2
            else [(0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (0, 2)])


def oracle_residual(etype, xe, ue, D, dens, b, thickness=1.0, ngp=None):
    """F = dens*dvol*N*b - dvol*B^T sigma, sigma = D (tensorial strain)."""
    npe, ndim = xe.shape
    if ngp is None:
        ngp = {"tria3": 1, "tria6": 3, "tetra4": 1, "prism6": 1,
               "hexa8": 8}[etype]
    pts, wts = _rule(etype, ngp)
    pairs = _voigt(ndim)
    F = np.zeros(npe * ndim)
    u = ue.reshape(npe, ndim)
    for xi, w in zip(pts, wts):
        N, dN = _shape(etype, xi)
        J = dN.T @ xe                    # J[a, d] = sum_i dN[i,a] x[i,d]
        det = np.linalg.det(J)
        g = dN @ np.linalg.inv(J).T      # g[i, d] = dN_i/dx_d
        dvol = w * det * (thickness if ndim == 2 else 1.0)
        H = u.T @ g                      # H[c, d] = du_c/dx_d
        strain = np.array([H[c, d] if c == d else 0.5 * (H[c, d] + H[d, c])
                           for (c, d) in pairs])
        sigma = D @ strain
        for i in range(npe):
            for c in range(ndim):
                fint = 0.0
                for s, (a_, d_) in enumerate(pairs):
                    if a_ == d_:
                        if c == a_:
                            fint += sigma[s] * g[i, a_]
                    else:
                        if c == a_:
                            fint += sigma[s] * g[i, d_]
                        elif c == d_:
                            fint += sigma[s] * g[i, a_]
                F[i * ndim + c] += dens * dvol * N[i] * b[c] - dvol * fint
    return F


def oracle_lumped_mass(etype, xe, dens, ndof, ngp):
    npe, ndim = xe.shape
    pts, wts = _rule(etype, ngp)
    M = np.zeros(npe)
    for xi, w in zip(pts, wts):
        N, dN = _shape(etype, xi)
        det = np.linalg.det(dN.T @ xe)
        M += dens * w * det * N * N.sum()
    return np.repeat(M, ndof)


def oracle_quad_hg(xe, ue, ve, E, nu, dens, b, thickness, wave_speed=50.0):
    """1-pt quad + viscous hourglass (elasticity2D.F:700-889): closed-form
    midpoint B from nodal coordinate differences, PLANE-STRESS stress."""
    x, y = xe[:, 0], xe[:, 1]
    area = 0.5 * ((x[2] - x[0]) * (y[3] - y[1]) + (x[1] - x[3]) * (y[2] - y[0]))
    f = 2.0 * area
    gx = np.array([y[1] - y[3], y[2] - y[0], y[3] - y[1], y[0] - y[2]]) / f
    gy = np.array([x[3] - x[1], x[0] - x[2], x[1] - x[3], x[2] - x[0]]) / f
    u = ue.reshape(4, 2)
    v = ve.reshape(4, 2)
    H = u.T @ np.stack([gx, gy], axis=1)     # H[c,d]
    strain = np.array([H[0, 0], H[1, 1], 0.5 * (H[0, 1] + H[1, 0])])
    sigma = dmat_plane_stress(E, nu) @ strain
    dvol = area * thickness
    F = np.zeros(8)
    hg = 0.25 * 1.0 * dens * wave_speed * np.sqrt(abs(area))
    gamma = np.array([1.0, -1.0, 1.0, -1.0])
    H1 = -(v[0, 0] - v[1, 0] + v[2, 0] - v[3, 0]) * hg
    H2 = -(v[0, 1] - v[1, 1] + v[2, 1] - v[3, 1]) * hg
    for i in range(4):
        F[2 * i] = (dens * dvol * 0.25 * b[0]
                    - dvol * (gx[i] * sigma[0] + gy[i] * sigma[2])
                    + gamma[i] * H1)
        F[2 * i + 1] = (dens * dvol * 0.25 * b[1]
                        - dvol * (gx[i] * sigma[2] + gy[i] * sigma[1])
                        + gamma[i] * H2)
    return F


# --------------------------------------------------------------------------
# per-element kernel equality
# --------------------------------------------------------------------------

_CASES = [
    ("tria3", lambda: generate.rect_tria(0, 1.3, 3, 0, 0.9, 2), 2),
    ("tria6", lambda: generate.rect_tria6(0, 1.1, 2, 0, 0.8, 2), 2),
    ("tetra4", lambda: generate.box_tet(0, 1, 2, 0, 1.2, 2, 0, 0.7, 2)[0], 3),
    ("prism6", lambda: generate.box_prism(0, 1, 2, 0, 1.1, 2, 0, 0.8, 2), 3),
    ("hexa8", lambda: generate.box_hexa(0, 1, 2, 0, 1.1, 2, 0, 0.8, 2), 3),
]


@pytest.mark.parametrize("etype,gen,ndim", _CASES)
def test_residual_matches_oracle(etype, gen, ndim):
    mesh = gen()
    assert mesh.etype == etype
    rng = np.random.default_rng(7)
    ue = rng.standard_normal((mesh.npe * ndim, mesh.n_elem)) * 1e-3
    D = dmat_plane_strain(210.0, 0.3) if ndim == 2 else dmat_3d(210.0, 0.3)
    b = np.array([1.5, -0.5, 0.25][:ndim])
    dens = 7.6
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))
    F = np.asarray(elasticity_residual(
        coords_em, jnp.asarray(ue), etype, D, dens, jnp.asarray(b),
        thickness=1.0 if ndim == 3 else 0.7))
    for e in range(min(mesh.n_elem, 12)):
        ref = oracle_residual(etype, mesh.elem_coords()[e], ue[:, e], D,
                              dens, b, thickness=0.7 if ndim == 2 else 1.0)
        np.testing.assert_allclose(F[:, e], ref, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("etype,gen,ndim", _CASES)
def test_lumped_mass_matches_oracle(etype, gen, ndim):
    mesh = gen()
    dens = 3.3
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))
    ngp = _MASS_NGP[etype]
    M = np.asarray(lumped_mass(coords_em, etype, dens, ndim, ngp=ngp))
    for e in range(min(mesh.n_elem, 12)):
        ref = oracle_lumped_mass(etype, mesh.elem_coords()[e], dens, ndim,
                                 ngp)
        np.testing.assert_allclose(M[:, e], ref, rtol=1e-9, atol=1e-12)
    # total mass = dens * volume (partition of unity)
    vol = {2: 1.3 * 0.9 if etype == "tria3" else 1.1 * 0.8,
           3: 1 * 1.2 * 0.7 if etype == "tetra4" else 1 * 1.1 * 0.8}[ndim]
    np.testing.assert_allclose(M.sum() / ndim, dens * vol, rtol=1e-9)


def test_quad_hg_matches_oracle():
    mesh = generate.rect_quad(0, 1.2, 3, 0, 0.8, 2)
    rng = np.random.default_rng(3)
    ue = rng.standard_normal((8, mesh.n_elem)) * 1e-3
    ve = rng.standard_normal((8, mesh.n_elem)) * 1e-2
    b = np.array([0.4, -1.1])
    E, nu, dens, thick = 1e9, 0.0, 1000.0, 0.025
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))
    F = np.asarray(quad_hg_residual(
        coords_em, jnp.asarray(ue), jnp.asarray(ve), E, nu, dens,
        jnp.asarray(b), thickness=thick))
    for e in range(mesh.n_elem):
        ref = oracle_quad_hg(mesh.elem_coords()[e], ue[:, e], ve[:, e],
                             E, nu, dens, b, thick)
        np.testing.assert_allclose(F[:, e], ref, rtol=1e-9, atol=1e-9)


# --------------------------------------------------------------------------
# full explicit loop vs oracle loop (composition check per element type)
# --------------------------------------------------------------------------

def _oracle_loop(mesh, dbc, E, nu, dens, dt, nsteps, b_of_t, thickness=1.0):
    ndof = mesh.ndim
    dofmap = build_dofmap(mesh, ndof, dbc)
    n_full = mesh.n_node * ndof
    ce = mesh.elem_coords()
    D = dmat_plane_strain(E, nu) if ndof == 2 else dmat_3d(E, nu)
    end = dofmap.elem_nodedof
    M = np.zeros(n_full)
    for e in range(mesh.n_elem):
        Me = oracle_lumped_mass(mesh.etype, ce[e], dens, ndof,
                                _MASS_NGP[mesh.etype])
        np.add.at(M, end[e], Me)
    free = dofmap.free_mask_full()
    u_n = np.zeros(n_full)
    u_nm1 = np.zeros(n_full)
    dtt = dt * dt
    for k in range(nsteps):
        b = np.asarray(b_of_t(k * dt))
        rhs = np.zeros(n_full)
        for e in range(mesh.n_elem):
            Fe = oracle_residual(mesh.etype, ce[e], u_n[end[e]], D, dens, b,
                                 thickness=thickness)
            np.add.at(rhs, end[e], Fe)
        rhs += M * (2 * u_n - u_nm1) / dtt
        u_np1 = np.where(free & (M > 0), dtt * rhs / np.where(M > 0, M, 1),
                         0.0)
        u_nm1, u_n = u_n, u_np1
    return u_n


@pytest.mark.parametrize("etype", ["tria6", "tetra4", "prism6"])
def test_explicit_loop_matches_oracle(etype):
    if etype == "tria6":
        mesh = generate.rect_tria6(0, 1, 2, 0, 1, 2)
        E, nu, dens, dt, nsteps = 1.7e7, 0.3, 1100.0, 1e-6, 12
        b_of_t = lambda t: np.array([3.0, 0.0])
        bf = lambda t: jnp.asarray([3.0, 0.0])
        fix = np.isclose(mesh.coords[:, 0], 0)
    elif etype == "tetra4":
        mesh, _ = generate.box_tet(0, 1, 2, 0, 1, 2, 0, 1, 2)
        E, nu, dens, dt, nsteps = 200.0, 0.3, 10.0, 1e-4, 12
        b_of_t = lambda t: np.array([1.0, 0.0, 0.0])
        bf = lambda t: jnp.asarray([1.0, 0.0, 0.0])
        fix = np.isclose(mesh.coords[:, 0], 0)
    else:
        mesh = generate.box_prism(0, 1, 2, 0, 1, 2, 0, 1, 2)
        E, nu, dens, dt, nsteps = 2.1e7, 0.1, 7.6, 2e-5, 12
        b_of_t = lambda t: np.array([100.0, 0.0, 0.0])
        bf = lambda t: jnp.asarray([100.0, 0.0, 0.0])
        fix = np.isclose(mesh.coords[:, 0], 0)
    nodes = np.nonzero(fix)[0]
    dbc = np.array([[n, d, 0.0] for n in nodes for d in range(mesh.ndim)])

    res = explicit_dynamics(mesh, dbc, E, nu, dens, dt, nsteps,
                            bforce_fn=bf)
    ref = _oracle_loop(mesh, dbc, E, nu, dens, dt, nsteps, b_of_t)
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(res.disp, ref, rtol=1e-7, atol=1e-14)
