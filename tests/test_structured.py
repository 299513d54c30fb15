"""Structured slice-add assembly vs general scatter assembly."""

import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.assembly.assemble import assemble_matrix, assemble_rhs
from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.assembly.structured import (
    assemble_dia_structured,
    assemble_rhs_structured,
    build_structured_plan,
)
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.elements.geometry import to_element_minor
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh import generate
from pfemfort_jax.sparse.dia import spmv_dia
from pfemfort_jax.sparse.ops import operator_and_diag


def test_structured_assembly_matches_general():
    nex, ney, nez = 3, 4, 5
    mesh, dbc = generate.box_tet(0, 1, nex, 0, 2, ney, 0, 1, nez)
    assert mesh.structure["kind"] == "box_tet"
    dofmap = build_dofmap(mesh, 1, dbc)
    n_full = mesh.n_node

    Ke, Fe = poisson_element_matrices(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tetra4",
        source=-6.0)

    # general full-system pattern (scatter path)
    pat = build_pattern(dofmap.elem_nodedof, n_full)
    A_gen = assemble_matrix(Ke, pat)
    b_gen = assemble_rhs(Fe, pat)

    # structured slice-add path
    plan = build_structured_plan(nex, ney, nez)
    A_str = assemble_dia_structured(Ke, plan)
    b_str = assemble_rhs_structured(Fe, plan)

    assert np.allclose(np.asarray(b_gen), np.asarray(b_str), atol=1e-12)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(n_full))
    op_gen, diag_gen = operator_and_diag(A_gen)
    assert np.allclose(np.asarray(op_gen(x)),
                       np.asarray(spmv_dia(A_str, x)), atol=1e-10)
    _, diag_str = operator_and_diag(A_str)
    assert np.allclose(np.asarray(diag_gen), np.asarray(diag_str))


def test_structured_full_solve_exact():
    mesh, dbc = generate.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 5)
    res = solve_poisson(mesh, dbc, rtol=1e-11, bc_mode="full")
    assert bool(np.asarray(res.stats.converged))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-8


def test_structured_flag_survives_io(tmp_path):
    """Meshes read back from .dat files have no structure metadata and fall
    back to the general path — same answer."""
    from pfemfort_jax.mesh import io as mesh_io

    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    prefix = str(tmp_path / "m")
    mesh_io.write_dat(prefix, mesh, dirichlet=dbc)
    mesh2, dbc2, _ = mesh_io.read_problem(prefix)
    assert mesh2.structure is None
    r1 = solve_poisson(mesh, dbc, rtol=1e-11, bc_mode="full")
    r2 = solve_poisson(mesh2, dbc2, rtol=1e-11, bc_mode="full")
    assert np.allclose(r1.u_full, r2.u_full, atol=1e-9)


def test_structured_elasticity_matches_general():
    """ndof=3 structured slice-add assembly == general scatter assembly."""
    import jax.numpy as jnp
    from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness

    nex, ney, nez = 3, 3, 4
    mesh, _ = generate.box_tet(0, 1, nex, 0, 1, ney, 0, 1, nez)
    dofmap = build_dofmap(mesh, 3, np.zeros((0, 3)))
    n_full = mesh.n_node * 3
    D = dmat_3d(240.565, 0.3)
    Ke, Fe = elasticity_stiffness(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tetra4", D,
        bforce=(0.1, 0.0, 0.0))

    pat = build_pattern(dofmap.elem_nodedof, n_full)
    A_gen = assemble_matrix(Ke, pat)
    b_gen = assemble_rhs(Fe, pat)

    plan = build_structured_plan(nex, ney, nez, ndof=3)
    A_str = assemble_dia_structured(Ke, plan)
    b_str = assemble_rhs_structured(Fe, plan)

    assert np.allclose(np.asarray(b_gen), np.asarray(b_str), atol=1e-9)
    x = jnp.asarray(np.random.default_rng(1).standard_normal(n_full))
    op_gen, _ = operator_and_diag(A_gen)
    assert np.allclose(np.asarray(op_gen(x)),
                       np.asarray(spmv_dia(A_str, x)), atol=1e-7)


def test_structured_elasticity_full_solve():
    """Beam-like elasticity through the full-system structured path matches
    the reduced solve."""
    from pfemfort_jax.drivers.elasticity import solve_elasticity

    mesh, _ = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 2, 6)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    tip = int(np.argmax(mesh.coords[:, 2]))
    fbc = np.array([[tip, 0, 1.0]])
    ref = solve_elasticity(mesh, dbc, 240.565, 0.3, force_bc=fbc,
                           rtol=1e-10)
    res = solve_elasticity(mesh, dbc, 240.565, 0.3, force_bc=fbc,
                           rtol=1e-10, bc_mode="full")
    assert bool(np.asarray(res.stats.converged))
    assert np.allclose(res.u_full, ref.u_full, atol=1e-7)


def test_structured_2d_matches_general():
    import jax.numpy as jnp
    from pfemfort_jax.assembly.structured import (
        assemble_dia_structured_2d,
        assemble_rhs_structured_2d,
        build_structured_plan_2d,
    )
    from pfemfort_jax.elements.poisson import poisson_element_matrices

    nex, ney = 5, 4
    mesh = generate.rect_tria(0, 1, nex, 0, 2, ney)
    dofmap = build_dofmap(mesh, 1, np.zeros((0, 3)))
    n_full = mesh.n_node
    Ke, Fe = poisson_element_matrices(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tria3",
        source=2.0)
    pat = build_pattern(dofmap.elem_nodedof, n_full)
    A_gen = assemble_matrix(Ke, pat)
    b_gen = assemble_rhs(Fe, pat)

    plan = build_structured_plan_2d(nex, ney)
    A_str = assemble_dia_structured_2d(Ke, plan)
    b_str = assemble_rhs_structured_2d(Fe, plan)

    assert np.allclose(np.asarray(b_gen), np.asarray(b_str), atol=1e-12)
    x = jnp.asarray(np.random.default_rng(2).standard_normal(n_full))
    op_gen, _ = operator_and_diag(A_gen)
    assert np.allclose(np.asarray(op_gen(x)),
                       np.asarray(spmv_dia(A_str, x)), atol=1e-10)


def test_structured_2d_full_solve():
    mesh = generate.rect_tria(0, 1, 12, 0, 1, 12)
    b = generate.boundary_nodes(mesh)
    dbc = np.stack([b.astype(float), np.zeros(len(b)),
                    np.sin(np.pi * mesh.coords[b, 0])], axis=1)
    ref = solve_poisson(mesh, dbc, rtol=1e-12)
    res = solve_poisson(mesh, dbc, rtol=1e-12, bc_mode="full")
    assert np.allclose(res.u_full, ref.u_full, atol=1e-9)


def test_reduce_structured_system_matches_general_path():
    """FULL structured assembly + slice reduction == reduced general-path
    assembly (matrix and rhs), on the flagship box-tet problem."""
    import jax.numpy as jnp

    from pfemfort_jax.assembly.assemble import (
        assemble_matrix, assemble_rhs, dirichlet_rhs_correction)
    from pfemfort_jax.assembly.pattern import build_pattern
    from pfemfort_jax.assembly.structured import (
        assemble_dia_structured, assemble_rhs_structured,
        build_structured_plan, reduce_structured_system)
    from pfemfort_jax.dofs.dofmap import (
        build_dofmap, full_lattice, reduced_box, reduced_lattice)
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    from pfemfort_jax.mesh import generate

    n = 6
    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    dofmap = build_dofmap(mesh, 1, dbc)
    coords_e = jnp.asarray(to_element_minor(mesh.elem_coords()))
    Ke, Fe = poisson_element_matrices(coords_e, "tetra4", source=-6.0)

    # general (scatter) reduced assembly — the oracle
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof,
                            lattice=reduced_lattice(mesh, dofmap))
    ubc_e = jnp.asarray(dofmap.bc_values_full[dofmap.elem_nodedof].T)
    A_ref = assemble_matrix(Ke, pattern)
    b_ref = assemble_rhs(Fe + dirichlet_rhs_correction(Ke, ubc_e), pattern)

    # structured full assembly + slice reduction
    plan = build_structured_plan(n, n, n)
    A_full = assemble_dia_structured(Ke, plan)
    b_full = assemble_rhs_structured(Fe, plan)
    A_red, b_red = reduce_structured_system(
        A_full, b_full, reduced_box(mesh, dofmap), full_lattice(mesh),
        jnp.asarray(dofmap.bc_values_full))

    assert A_red.n_rows == A_ref.n_rows
    # compare as dense maps applied to probes (offset sets may differ by
    # zero-only diagonals)
    rng = np.random.default_rng(0)
    from pfemfort_jax.sparse.dia import spmv_dia
    for _ in range(3):
        x = jnp.asarray(rng.standard_normal(A_ref.n_rows))
        np.testing.assert_allclose(np.asarray(spmv_dia(A_red, x)),
                                   np.asarray(spmv_dia(A_ref, x)),
                                   atol=1e-11)
    np.testing.assert_allclose(np.asarray(b_red), np.asarray(b_ref),
                               atol=1e-11)


def test_chunked_structured_assembly_matches_oneshot():
    """z-slab-chunked fori_loop assembler == one-shot slice-add assembler."""
    import jax
    import jax.numpy as jnp

    from pfemfort_jax.assembly.structured import (
        assemble_dia_structured, assemble_rhs_structured,
        assemble_structured_chunked, build_structured_plan)
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    from pfemfort_jax.mesh import generate

    n = 6
    mesh, _ = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    coords = jnp.asarray(to_element_minor(mesh.elem_coords()))
    plan = build_structured_plan(n, n, n)
    efn = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)
    Ke, Fe = efn(coords)
    A0 = assemble_dia_structured(Ke, plan)
    b0 = assemble_rhs_structured(Fe, plan)
    for nc in (2, 3):
        A1, b1 = jax.jit(
            lambda c, nc=nc: assemble_structured_chunked(efn, c, plan, nc)
        )(coords)
        np.testing.assert_allclose(np.asarray(A1.vals), np.asarray(A0.vals),
                                   atol=1e-13)
        np.testing.assert_allclose(np.asarray(b1), np.asarray(b0),
                                   atol=1e-13)
