"""Explicit central-difference dynamics tests (vs an independent numpy
reference implementation of the Fortran time loop)."""

import jax.numpy as jnp
import numpy as np

from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.dynamics.explicit import explicit_dynamics
from pfemfort_jax.elements.elasticity import (
    dmat_plane_strain,
    elasticity_residual,
    lumped_mass,
)
from pfemfort_jax.mesh import generate


def _numpy_reference_loop(mesh, dbc, E, nu, dens, dt, nsteps, pulse_t):
    """Straight transcription of the reference update
    (/root/reference/src/triaelasticityexplicit.F:970-1123) in numpy, using
    our batched kernels only for the per-element residual/mass."""
    ndof = 2
    dofmap = build_dofmap(mesh, ndof, dbc)
    n_full = mesh.n_node * ndof
    from pfemfort_jax.elements.geometry import to_element_minor
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))

    Me = np.asarray(lumped_mass(coords_em, mesh.etype, dens, ndof)).T
    M = np.zeros(n_full)
    end = dofmap.elem_nodedof
    for e in range(mesh.n_elem):
        for i in range(end.shape[1]):
            M[end[e, i]] += Me[e, i]

    D = dmat_plane_strain(E, nu)
    free = dofmap.free_mask_full()
    u_n = np.zeros(n_full)     # u^n   ("dispPrev" after the Fortran rotation)
    u_nm1 = np.zeros(n_full)   # u^{n-1} ("dispPrev2")
    probe = (2, 3)
    probe_hist = []
    dtt = dt * dt
    for k in range(nsteps):
        t = k * dt
        b = np.array([1.0 if t <= pulse_t else 0.0, 0.0])
        de = u_n[dofmap.elem_nodedof]          # (E, ns)
        Fe = np.asarray(elasticity_residual(
            coords_em, jnp.asarray(de.T), mesh.etype, D, dens,
            jnp.asarray(b))).T
        rhs = np.zeros(n_full)
        for e in range(mesh.n_elem):
            for i in range(end.shape[1]):
                rhs[end[e, i]] += Fe[e, i]
        rhs = rhs + M * (2 * u_n - u_nm1) / dtt
        u_np1 = np.where(free & (M > 0), dtt * rhs / np.where(M > 0, M, 1), 0.0)
        probe_hist.append(np.concatenate(
            [u_np1[list(probe)], (u_np1 - u_nm1)[list(probe)] / (2 * dt)]))
        u_nm1, u_n = u_n, u_np1
    return u_n, np.asarray(probe_hist)


def test_explicit_matches_numpy_reference():
    mesh = generate.rect_tria(0, 1, 3, 0, 1, 2)
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    E, nu, dens, dt, nsteps = 200.0, 0.3, 10.0, 2e-4, 25

    res = explicit_dynamics(
        mesh, dbc, E, nu, dens, dt, nsteps,
        bforce_fn=lambda t: jnp.stack(
            [jnp.where(t <= 0.1, 1.0, 0.0), jnp.zeros(())]),
        probe_dofs=(2, 3),
    )
    ref, ref_hist = _numpy_reference_loop(mesh, dbc, E, nu, dens, dt,
                                          nsteps, 0.1)
    assert np.allclose(res.disp, ref, rtol=1e-9, atol=1e-12)
    assert res.probe_history.shape == (nsteps, 4)
    assert np.allclose(res.probe_history, ref_hist, rtol=1e-9, atol=1e-12)


def test_explicit_bc_dofs_stay_zero():
    mesh = generate.rect_tria(0, 1, 4, 0, 1, 4)
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    res = explicit_dynamics(
        mesh, dbc, 200.0, 0.3, 10.0, 1e-4, 50,
        bforce_fn=lambda t: jnp.asarray([1.0, 0.0]))
    u = res.disp.reshape(-1, 2)
    assert np.allclose(u[left], 0.0)
    # free nodes actually moved
    assert np.abs(u).max() > 0


def test_explicit_quad_hourglass_matches_oracle():
    """Full HG quad loop vs the independent numpy oracle element
    (tests/test_explicit_oracles.py:oracle_quad_hg) with the same
    velocity-carrying central-difference update."""
    from tests.test_explicit_oracles import oracle_quad_hg

    mesh = generate.rect_quad(0, 1, 4, 0, 1, 2)
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    E, nu, dens, dt, nsteps, thick = 1e9, 0.0, 1000.0, 1e-5, 30, 0.025
    fbc = np.array([[mesh.n_node - 1, 1, 5.0]])
    res = explicit_dynamics(
        mesh, dbc, E, nu, dens, dt, nsteps,
        bforce_fn=lambda t: jnp.asarray([0.0, 0.0]),
        force_bc=fbc, thickness=thick, use_hourglass=True,
    )

    # independent loop
    dofmap = build_dofmap(mesh, 2, dbc)
    n_full = mesh.n_node * 2
    ce = mesh.elem_coords()
    end = dofmap.elem_nodedof
    from tests.test_explicit_oracles import oracle_lumped_mass
    M = np.zeros(n_full)
    for e in range(mesh.n_elem):
        np.add.at(M, end[e], oracle_lumped_mass("quad4", ce[e], dens, 2, 4))
    fext = np.zeros(n_full)
    fext[(mesh.n_node - 1) * 2 + 1] = 5.0
    free = dofmap.free_mask_full()
    u_n = np.zeros(n_full); u_nm1 = np.zeros(n_full); v_n = np.zeros(n_full)
    dtt = dt * dt
    for k in range(nsteps):
        rhs = fext.copy()
        for e in range(mesh.n_elem):
            Fe = oracle_quad_hg(ce[e], u_n[end[e]], v_n[end[e]],
                                E, nu, dens, np.zeros(2), thick)
            np.add.at(rhs, end[e], Fe)
        rhs += M * (2 * u_n - u_nm1) / dtt
        u_np1 = np.where(free & (M > 0), dtt * rhs / np.where(M > 0, M, 1),
                         0.0)
        v_n = (u_np1 - u_nm1) / (2 * dt)
        u_nm1, u_n = u_n, u_np1
    assert np.abs(u_n).max() > 0
    np.testing.assert_allclose(res.disp, u_n, rtol=1e-7, atol=1e-14)


# prism6 / tetra4 / tria6 full-loop value checks live in
# tests/test_explicit_oracles.py (test_explicit_loop_matches_oracle),
# against fully independent per-element numpy oracles.
