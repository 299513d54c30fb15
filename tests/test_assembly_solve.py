"""Assembly vs dense oracle, CG solver, and end-to-end Poisson/elasticity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.conftest import dense_assemble

from pfemfort_jax.assembly.assemble import (
    assemble_ell_values,
    assemble_rhs,
    dirichlet_rhs_correction,
)
from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.drivers.elasticity import solve_elasticity
from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.elements.elasticity import dmat_plane_stress, elasticity_stiffness
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh import generate
from pfemfort_jax.solve.cg import cg_solve, bicgstab_solve, jacobi_preconditioner
from pfemfort_jax.sparse.spmv import extract_diagonal, spmv_ell
from pfemfort_jax.elements.geometry import to_element_minor


def _em(mesh):
    return jnp.asarray(to_element_minor(mesh.elem_coords()))


def _K_np(K):
    return np.asarray(K).transpose(2, 0, 1)


def _F_np(F):
    return np.asarray(F).T


def _ell_to_dense(A):
    n = A.n_rows
    dense = np.zeros((n, A.n_cols))
    cols = np.asarray(A.cols)
    vals = np.asarray(A.vals)
    for i in range(n):
        for k in range(A.k):
            c = cols[i, k]
            if c < A.n_cols:
                dense[i, c] += vals[i, k]
    return dense


def _square_dirichlet(mesh, value_fn):
    bnodes = generate.boundary_nodes(mesh)
    vals = value_fn(mesh.coords[bnodes])
    return np.stack([bnodes.astype(float), np.zeros(len(bnodes)), vals], axis=1)


def test_assembly_matches_dense_oracle():
    mesh = generate.rect_tria(0, 1, 4, 0, 1, 4)
    dbc = _square_dirichlet(mesh, lambda p: p[:, 0] + 2 * p[:, 1])
    dofmap = build_dofmap(mesh, 1, dbc)
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof, layout="ell")

    Ke, Fe = poisson_element_matrices(_em(mesh), "tria3", source=1.5)
    A = assemble_ell_values(Ke, pattern, jnp.asarray(pattern.ell_cols))
    ubc_e = jnp.asarray(dofmap.bc_values_full[dofmap.elem_nodedof].T)
    b = assemble_rhs(Fe + dirichlet_rhs_correction(Ke, ubc_e), pattern)

    A_ref, b_ref = dense_assemble(
        mesh, dofmap, _K_np(Ke), _F_np(Fe))
    assert np.allclose(_ell_to_dense(A), A_ref, atol=1e-12)
    assert np.allclose(np.asarray(b), b_ref, atol=1e-12)


def test_spmv_and_diagonal():
    mesh = generate.rect_tria(0, 1, 3, 0, 1, 3)
    dbc = _square_dirichlet(mesh, lambda p: np.zeros(len(p)))
    dofmap = build_dofmap(mesh, 1, dbc)
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof, layout="ell")
    Ke, _ = poisson_element_matrices(_em(mesh), "tria3")
    A = assemble_ell_values(Ke, pattern, jnp.asarray(pattern.ell_cols))
    dense = _ell_to_dense(A)
    x = np.random.default_rng(3).standard_normal(dofmap.total_dof)
    assert np.allclose(np.asarray(spmv_ell(A, jnp.asarray(x))), dense @ x)
    assert np.allclose(np.asarray(extract_diagonal(A)), np.diag(dense))


def test_cg_and_bicgstab_on_spd():
    rng = np.random.default_rng(4)
    n = 40
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    op = lambda x: jnp.asarray(A) @ x
    x, stats = cg_solve(op, jnp.asarray(b), rtol=1e-12,
                        precond=jacobi_preconditioner(jnp.asarray(np.diag(A))))
    assert bool(stats.converged)
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-8)
    x2, stats2 = bicgstab_solve(op, jnp.asarray(b), rtol=1e-12)
    assert bool(stats2.converged)
    assert np.allclose(np.asarray(x2), np.linalg.solve(A, b), atol=1e-6)


def test_poisson_2d_matches_dense_solve():
    mesh = generate.rect_tria(0, 1, 8, 0, 1, 8)
    dbc = _square_dirichlet(
        mesh, lambda p: np.sin(np.pi * p[:, 0]) * np.cosh(np.pi * p[:, 1]))
    res = solve_poisson(mesh, dbc, rtol=1e-12)
    assert res.stats.converged

    dofmap = build_dofmap(mesh, 1, dbc)
    Ke, Fe = poisson_element_matrices(_em(mesh), "tria3")
    A_ref, b_ref = dense_assemble(mesh, dofmap, _K_np(Ke), _F_np(Fe))
    u_ref = np.linalg.solve(A_ref, b_ref)
    assert np.allclose(np.asarray(res.u_reduced), u_ref, atol=1e-9)


def test_poisson_2d_laplace_analytic():
    """Unit-square Laplace with the serial driver's analytic check
    u = (cosh(pi y) - sinh(pi y)/tanh(pi)) sin(pi x)
    (/root/reference/src/triapoissonserialimpl1.F:739-740)."""
    mesh = generate.rect_tria(0, 1, 20, 0, 1, 20)

    def u_exact(p):
        x, y = p[:, 0], p[:, 1]
        return (np.cosh(np.pi * y)
                - np.sinh(np.pi * y) / np.tanh(np.pi)) * np.sin(np.pi * x)

    dbc = _square_dirichlet(mesh, u_exact)
    res = solve_poisson(mesh, dbc, rtol=1e-10)
    assert res.stats.converged
    err = np.abs(res.u_full - u_exact(mesh.coords))
    assert err.max() < 5e-3, err.max()  # discretization-level error


def test_poisson_3d_manufactured():
    """Box tet mesh, f=-6, u = x^2+y^2+z^2 manufactured solution (the
    reference's flagship 3D benchmark; genTetra.cpp:516-524)."""
    mesh, dbc = generate.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 5)
    res = solve_poisson(mesh, dbc, rtol=1e-11)
    assert res.stats.converged
    u_exact = (mesh.coords ** 2).sum(axis=1)
    err = np.abs(res.u_full - u_exact)
    # On the uniform 6-tet split, linear FEM is nodally EXACT for this
    # quadratic solution — interior values match to solver tolerance, which
    # makes every nodal value checkable (the property the reference's
    # verification strategy relies on, SURVEY §4).
    assert err.max() < 1e-8, err.max()


def test_elasticity_2d_matches_dense_solve():
    mesh = generate.rect_tria(0, 2, 4, 0, 1, 3)
    # clamp x=0 edge, pull +x on x=2 edge nodes
    left = np.nonzero(np.isclose(mesh.coords[:, 0], 0))[0]
    right = np.nonzero(np.isclose(mesh.coords[:, 0], 2))[0]
    dbc = np.array([[n, d, 0.0] for n in left for d in (0, 1)])
    fbc = np.array([[n, 0, 1.0] for n in right])
    E_, nu = 240.565, 0.3
    res = solve_elasticity(mesh, dbc, E_, nu, force_bc=fbc, rtol=1e-12)
    assert res.stats.converged

    dofmap = build_dofmap(mesh, 2, dbc)
    D = dmat_plane_stress(E_, nu)
    Ke, Fe = elasticity_stiffness(_em(mesh), "tria3", D)
    A_ref, b_ref = dense_assemble(mesh, dofmap, _K_np(Ke), _F_np(Fe))
    for n, d, v in fbc:
        r = dofmap.node_dof[int(n), int(d)]
        if r >= 0:
            b_ref[r] += v
    u_ref = np.linalg.solve(A_ref, b_ref)
    assert np.allclose(np.asarray(res.u_reduced), u_ref, atol=1e-8)
    # pulled edge moves +x
    ux = res.u_full.reshape(-1, 2)[right, 0]
    assert (ux > 0).all()


def test_cook_membrane_reference_mesh(cookmembrane):
    """Cook's membrane golden run on the bundled reference mesh."""
    mesh, dbc, fbc = cookmembrane
    assert mesh.etype == "tria3"
    assert mesh.n_elem == 2048 and mesh.n_node == 1089
    res = solve_elasticity(mesh, dbc, 240.565, 0.3, force_bc=fbc, rtol=1e-10)
    assert res.stats.converged
    # Cook's membrane: loaded tip corner (max x+y) deflects upward.
    tip = np.argmax(mesh.coords.sum(axis=1))
    uy = res.u_full.reshape(-1, 2)[tip, 1]
    assert uy > 0, uy


def test_tria20x20_reference_mesh(tria20x20):
    mesh, dbc, _ = tria20x20
    assert mesh.n_node == 441 and mesh.n_elem == 800
    res = solve_poisson(mesh, dbc, rtol=1e-10)
    assert res.stats.converged
    dofmap = build_dofmap(mesh, 1, dbc)
    Ke, Fe = poisson_element_matrices(_em(mesh), "tria3")
    A_ref, b_ref = dense_assemble(mesh, dofmap, _K_np(Ke), _F_np(Fe))
    u_ref = np.linalg.solve(A_ref, b_ref)
    assert np.allclose(np.asarray(res.u_reduced), u_ref, atol=1e-8)


def test_tet10_reference_mesh(tet10):
    mesh, dbc, _ = tet10
    assert mesh.etype == "tetra4"
    res = solve_poisson(mesh, dbc, rtol=1e-9)
    assert res.stats.converged
    # manufactured solution u = x^2+y^2+z^2 on [-0.5, 0.5]^3-ish box
    u_exact = (mesh.coords ** 2).sum(axis=1)
    err = np.abs(res.u_full - u_exact).max()
    assert err < 5e-2, err


def test_beam3d_elasticity(beam3d):
    mesh, dbc, fbc = beam3d
    assert mesh.etype == "tetra4"
    res = solve_elasticity(mesh, dbc, 240.565, 0.3, force_bc=fbc, rtol=1e-8)
    assert res.stats.converged
    assert np.isfinite(res.u_full).all()


def test_delaunay_truly_unstructured_poisson():
    """A GENUINELY unstructured tet mesh (Delaunay of a jittered point
    cloud — no lattice to recover, arbitrary valences): the general ELL
    assembly + CG pipeline must match a scipy direct solve of the same
    system to solver precision, and approximate the manufactured PDE
    solution at O(h^2).  Everything else in the suite is lattice-derived;
    this pins down the no-structure-at-all case."""
    import numpy as np
    import scipy.sparse as ssp
    import scipy.sparse.linalg as sla
    from scipy.spatial import Delaunay

    import jax.numpy as jnp

    from pfemfort_jax.assembly.assemble import (
        assemble_matrix, assemble_rhs, dirichlet_rhs_correction)
    from pfemfort_jax.assembly.pattern import build_pattern
    from pfemfort_jax.dofs.dofmap import build_dofmap
    from pfemfort_jax.drivers.poisson import solve_poisson
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    from pfemfort_jax.mesh.core import Mesh

    rng = np.random.default_rng(0)
    n = 6
    g = np.linspace(0, 1, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    interior = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[interior] += rng.uniform(-0.25, 0.25, (int(interior.sum()), 3)) / n
    tri = Delaunay(pts)
    conn = tri.simplices.astype(np.int64)
    a, b, c, d = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    neg = vol6 < 0
    conn[neg] = conn[neg][:, [0, 2, 1, 3]]
    vol6 = np.abs(vol6)
    conn = conn[vol6 > 1e-12]           # drop coplanar slivers
    mesh = Mesh("tetra4", pts, conn.astype(np.int32))
    hull = np.unique(tri.convex_hull)
    u_ex = (pts ** 2).sum(axis=1)
    dbc = np.stack([hull, np.zeros(len(hull)), u_ex[hull]], axis=1)

    res = solve_poisson(mesh, dbc, rtol=1e-12)
    assert bool(np.asarray(res.stats.converged))
    assert not res.timings.get("structure_recovered", False)

    dm = build_dofmap(mesh, 1, dbc)
    pat = build_pattern(dm.elem_dof, dm.total_dof, layout="ell")
    coords = jnp.asarray(to_element_minor(mesh.elem_coords()))
    ubc = jnp.asarray(dm.bc_values_full[dm.elem_nodedof].T)
    Ke, Fe = poisson_element_matrices(coords, "tetra4", source=-6.0)
    A = assemble_matrix(Ke, pat)
    bb = assemble_rhs(Fe + dirichlet_rhs_correction(Ke, ubc), pat)
    rows = np.repeat(np.arange(pat.n_rows), pat.ell_k)
    cols = np.asarray(A.cols).reshape(-1)
    vals = np.asarray(A.vals).reshape(-1)
    keep = cols < pat.n_rows
    S = ssp.csr_matrix((vals[keep], (rows[keep], cols[keep])),
                       shape=(pat.n_rows, pat.n_rows))
    u_direct = sla.spsolve(S.tocsc(), np.asarray(bb))
    scale = np.abs(u_direct).max()
    assert np.abs(np.asarray(res.u_reduced) - u_direct).max() < 1e-9 * scale
    assert np.abs(res.u_full - u_ex).max() < 0.05   # O(h^2) at h=1/6
