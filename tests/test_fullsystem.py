"""serialimpl3-parity full-system BC mode: must match the reduced system."""

import numpy as np
import pytest

from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.mesh import generate


def _dbc_square(mesh, fn):
    b = generate.boundary_nodes(mesh)
    return np.stack([b.astype(float), np.zeros(len(b)), fn(mesh.coords[b])],
                    axis=1)


@pytest.mark.parametrize("method", ["cg", "bicgstab", "gmres"])
def test_full_mode_matches_reduced_2d(method):
    mesh = generate.rect_tria(0, 1, 8, 0, 1, 8)
    dbc = _dbc_square(
        mesh, lambda p: np.sin(np.pi * p[:, 0]) * (1 - p[:, 1]))
    ref = solve_poisson(mesh, dbc, rtol=1e-12)
    res = solve_poisson(mesh, dbc, rtol=1e-12, bc_mode="full", method=method)
    assert bool(np.asarray(res.stats.converged)), res.stats
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)
    # BC rows carry exactly the applied values
    bn = dbc[:, 0].astype(int)
    assert np.allclose(res.u_full[bn], dbc[:, 2], atol=1e-12)


def test_full_mode_matches_reduced_3d():
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    ref = solve_poisson(mesh, dbc, rtol=1e-11)
    res = solve_poisson(mesh, dbc, rtol=1e-11, bc_mode="full")
    assert bool(np.asarray(res.stats.converged))
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-8


def test_refine_through_driver():
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    res = solve_poisson(mesh, dbc, rtol=1e-10, refine=True)
    assert bool(np.asarray(res.stats.converged))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-7


def test_matrix_free_matches_assembled():
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    ref = solve_poisson(mesh, dbc, rtol=1e-11)
    res = solve_poisson(mesh, dbc, rtol=1e-11, matrix_free=True)
    assert bool(np.asarray(res.stats.converged))
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)
    # same iteration count: identical operator, just never materialized
    assert abs(int(res.stats.iters) - int(ref.stats.iters)) <= 1


def test_matrix_free_2d():
    mesh = generate.rect_tria(0, 1, 10, 0, 1, 10)
    b = generate.boundary_nodes(mesh)
    dbc = np.stack([b.astype(float), np.zeros(len(b)),
                    np.sin(np.pi * mesh.coords[b, 0])], axis=1)
    ref = solve_poisson(mesh, dbc, rtol=1e-11)
    res = solve_poisson(mesh, dbc, rtol=1e-11, matrix_free=True)
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)


def test_hexa8_poisson_solve():
    """Trilinear hex Poisson (an element type the reference never finished a
    driver for) through the generic pipeline."""
    mesh = generate.box_hexa(0, 1, 5, 0, 1, 5, 0, 1, 5)
    bn = generate.boundary_nodes(mesh)
    u_b = (mesh.coords[bn] ** 2).sum(axis=1)
    dbc = np.stack([bn.astype(float), np.zeros(len(bn)), u_b], axis=1)
    res = solve_poisson(mesh, dbc, rtol=1e-11, source=-6.0)
    assert bool(np.asarray(res.stats.converged))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    # trilinear hexes are also nodally exact for this quadratic on a
    # uniform grid
    assert np.abs(res.u_full - u_exact).max() < 1e-7
