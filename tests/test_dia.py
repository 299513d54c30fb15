"""DIA-direct assembly and SpMV tests: must agree exactly with the general
ELL path on identical meshes."""

import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.assembly.assemble import (
    assemble_matrix,
    assemble_rhs,
)
from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness
from pfemfort_jax.mesh import generate
from pfemfort_jax.sparse.dia import DIAMatrix, dia_diagonal, spmv_dia
from pfemfort_jax.sparse.formats import ELLMatrix
from pfemfort_jax.sparse.spmv import extract_diagonal, spmv_ell


def _system(mesh, ndof, dbc, element_fn, layout="auto"):
    dofmap = build_dofmap(mesh, ndof, dbc)
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof, layout=layout)
    from pfemfort_jax.elements.geometry import to_element_minor
    Ke, _ = element_fn(jnp.asarray(to_element_minor(mesh.elem_coords())))
    A = assemble_matrix(Ke, pattern)
    return dofmap, pattern, A


def test_box_tet_pattern_is_dia_and_matches_ell():
    mesh, dbc = generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
    efn = lambda c: poisson_element_matrices(c, "tetra4")
    dofmap, pat_d, Ad = _system(mesh, 1, dbc, efn, layout="auto")
    assert pat_d.layout == "dia"
    assert isinstance(Ad, DIAMatrix)
    assert len(Ad.offsets) == 15  # the 6-tet split stencil

    _, pat_e, Ae = _system(mesh, 1, dbc, efn, layout="ell")
    assert isinstance(Ae, ELLMatrix)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(pat_d.n_rows))
    assert np.allclose(np.asarray(spmv_ell(Ae, x)),
                       np.asarray(spmv_dia(Ad, x)), atol=1e-12)
    assert np.allclose(np.asarray(dia_diagonal(Ad)),
                       np.asarray(extract_diagonal(Ae)))


def test_rhs_assembly_same_both_layouts():
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    dofmap = build_dofmap(mesh, 1, dbc)
    from pfemfort_jax.elements.geometry import to_element_minor
    Ke, Fe = poisson_element_matrices(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tetra4",
        source=-6.0)
    pd = build_pattern(dofmap.elem_dof, dofmap.total_dof, layout="dia")
    pe = build_pattern(dofmap.elem_dof, dofmap.total_dof, layout="ell")
    assert np.allclose(np.asarray(assemble_rhs(Fe, pd)),
                       np.asarray(assemble_rhs(Fe, pe)))


def test_rect_tria_pattern_is_dia():
    mesh = generate.rect_tria(0, 1, 10, 0, 1, 10)
    b = generate.boundary_nodes(mesh)
    dbc = np.stack([b.astype(float), np.zeros(len(b)), np.zeros(len(b))], 1)
    efn = lambda c: poisson_element_matrices(c, "tria3")
    _, pat, Ad = _system(mesh, 1, dbc, efn)
    assert pat.layout == "dia"
    _, _, Ae = _system(mesh, 1, dbc, efn, layout="ell")
    x = jnp.asarray(np.random.default_rng(1).standard_normal(pat.n_rows))
    assert np.allclose(np.asarray(spmv_ell(Ae, x)),
                       np.asarray(spmv_dia(Ad, x)), atol=1e-12)


def test_elasticity_3d_dia_matches_ell():
    mesh, _ = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 3)
    base = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    D = dmat_3d(240.565, 0.3)
    efn = lambda c: elasticity_stiffness(c, "tetra4", D)
    _, pat, Am = _system(mesh, 3, dbc, efn)
    _, _, Ae = _system(mesh, 3, dbc, efn, layout="ell")
    x = jnp.asarray(np.random.default_rng(2).standard_normal(pat.n_rows))
    ya = spmv_dia(Am, x) if isinstance(Am, DIAMatrix) else spmv_ell(Am, x)
    assert np.allclose(np.asarray(spmv_ell(Ae, x)), np.asarray(ya),
                       atol=1e-9)


def test_unstructured_mesh_falls_back_to_ell():
    """A randomly permuted node numbering destroys the lattice offsets; the
    driver must still solve correctly through the ELL path."""
    mesh, dbc = generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
    rng = np.random.default_rng(3)
    perm = rng.permutation(mesh.n_node).astype(np.int32)
    mesh2 = mesh.renumbered(perm)
    dbc2 = dbc.copy()
    dbc2[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    dofmap = build_dofmap(mesh2, 1, dbc2)
    pat = build_pattern(dofmap.elem_dof, dofmap.total_dof)
    assert pat.layout == "ell"
    res = solve_poisson(mesh2, dbc2, rtol=1e-10)
    assert res.stats.converged
    u_exact = (mesh2.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-8


def test_solve_poisson_uses_dia_and_matches():
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    res = solve_poisson(mesh, dbc, rtol=1e-11)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-8


def test_lattice_stencil_spmv_matches_flat():
    """DIAMatrix.lattice fast path (N-D stencil slices) is bit-identical to
    the generic 1-D shifted-FMA path on assembled FEM matrices."""
    import jax.numpy as jnp
    from pfemfort_jax.assembly.assemble import assemble_matrix
    from pfemfort_jax.assembly.pattern import build_pattern
    from pfemfort_jax.dofs.dofmap import build_dofmap, reduced_lattice
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    from pfemfort_jax.mesh import generate
    from pfemfort_jax.sparse.dia import spmv_dia

    rng = np.random.default_rng(3)
    mesh, dbc = generate.box_tet(0, 1, 7, 0, 1, 9, 0, 1, 8)
    dofmap = build_dofmap(mesh, 1, dbc)
    lat = reduced_lattice(mesh, dofmap)
    assert lat == (7, 8, 6)
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof, lattice=lat)
    coords_e = jnp.asarray(to_element_minor(mesh.elem_coords()))
    Ke, _ = poisson_element_matrices(coords_e, "tetra4")
    A = assemble_matrix(Ke, pattern)
    assert A.lattice == lat
    x = jnp.asarray(rng.normal(size=(dofmap.total_dof,)))
    np.testing.assert_array_equal(
        np.asarray(spmv_dia(A, x)),
        np.asarray(spmv_dia(A._replace(lattice=None), x)))


def test_decompose_offsets():
    from pfemfort_jax.sparse.dia import decompose_offsets

    # canonical 3D 7-point stencil on (9, 9, 9)
    offs = (-81, -9, -1, 0, 1, 9, 81)
    d = decompose_offsets(offs, (9, 9, 9))
    assert d == ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0),
                 (0, 0, 1), (0, 1, 0), (1, 0, 0))
    # shift magnitude >= axis/2 is ambiguous -> None
    assert decompose_offsets((8,), (4, 4)) is None
