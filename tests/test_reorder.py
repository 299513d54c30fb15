"""Geometric structure recovery (mesh/reorder.py): a permuted lattice mesh
must be renumbered back to the gather-free DIA numbering, transparently."""

import numpy as np
import pytest

from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.mesh import generate
from pfemfort_jax.mesh.reorder import (
    geometric_node_order,
    recover_structure,
)


def _scrambled(n=6, seed=0):
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    m2 = mesh.renumbered(perm.astype(np.int64))
    d2 = dbc.copy()
    d2[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, m2, d2, perm


def test_lexsort_restores_lattice():
    mesh, m2, d2, perm = _scrambled()
    gp = geometric_node_order(m2.coords)
    # composing the scramble with the recovery is the identity on coords
    np.testing.assert_allclose(m2.coords[np.argsort(gp)], mesh.coords)


def test_recover_structure_finds_dia():
    mesh, m2, d2, _ = _scrambled()
    rec = recover_structure(m2, 1, d2)
    assert rec is not None
    mesh3, dbc3, _, perm, _ = rec
    from pfemfort_jax.assembly.pattern import _offset_census
    from pfemfort_jax.dofs.dofmap import build_dofmap
    dm3 = build_dofmap(mesh3, 1, dbc3)
    assert len(_offset_census(dm3.elem_dof, dm3.total_dof)) <= 128


def test_recovery_not_applied_to_structured_or_dia_meshes():
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    assert recover_structure(mesh, 1, dbc) is None   # has structure
    mesh2 = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)[0]
    mesh2.structure = None
    assert recover_structure(mesh2, 1, dbc) is None  # census already small


def test_solve_recovers_and_maps_back():
    mesh, m2, d2, _ = _scrambled(7, seed=3)
    res = solve_poisson(m2, d2, rtol=1e-11)
    assert res.timings.get("structure_recovered")
    ue = (m2.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - ue).max() < 1e-8
    # and the unrecovered ELL path gives the same answer
    from pfemfort_jax.drivers.common import solve_implicit
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    res0 = solve_implicit(
        m2, 1, d2, lambda c: poisson_element_matrices(
            c, "tetra4", source=-6.0), rtol=1e-11, recover=False)
    assert "structure_recovered" not in res0.timings
    assert np.abs(res0.u_full - res.u_full).max() < 1e-8
