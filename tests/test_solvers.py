"""GMRES and block-Jacobi preconditioner tests."""

import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.assembly.assemble import assemble_matrix
from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness
from pfemfort_jax.elements.geometry import to_element_minor
from pfemfort_jax.mesh import generate
from pfemfort_jax.solve.cg import cg_solve, jacobi_preconditioner
from pfemfort_jax.solve.gmres import gmres_solve
from pfemfort_jax.solve.precond import block_jacobi_preconditioner
from pfemfort_jax.sparse.ops import operator_and_diag


def test_gmres_on_spd():
    rng = np.random.default_rng(0)
    n = 50
    Q = rng.standard_normal((n, n))
    A = Q @ Q.T + n * np.eye(n)
    b = rng.standard_normal(n)
    op = lambda x: jnp.asarray(A) @ x
    x, stats = gmres_solve(op, jnp.asarray(b), rtol=1e-10, restart=20)
    assert bool(stats.converged), stats
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-6)


def test_gmres_on_nonsymmetric():
    rng = np.random.default_rng(1)
    n = 40
    A = rng.standard_normal((n, n)) + n * np.eye(n)   # diagonally dominant
    b = rng.standard_normal(n)
    op = lambda x: jnp.asarray(A) @ x
    x, stats = gmres_solve(op, jnp.asarray(b), rtol=1e-10, restart=15,
                           precond=jacobi_preconditioner(
                               jnp.asarray(np.diag(A))))
    assert bool(stats.converged)
    assert np.allclose(np.asarray(x), np.linalg.solve(A, b), atol=1e-6)


def _elasticity_system():
    """3D elasticity with ALL-dof BCs per node so nodal blocks stay aligned."""
    mesh, _ = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 3)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    dofmap = build_dofmap(mesh, 3, dbc)
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof)
    D = dmat_3d(240.565, 0.3)
    Ke, _ = elasticity_stiffness(
        jnp.asarray(to_element_minor(mesh.elem_coords())), "tetra4", D)
    A = assemble_matrix(Ke, pattern)
    rng = np.random.default_rng(2)
    b = jnp.asarray(rng.standard_normal(dofmap.total_dof))
    return A, b


def test_block_jacobi_beats_or_matches_scalar():
    A, b = _elasticity_system()
    op, diag = operator_and_diag(A)

    x1, s1 = cg_solve(op, b, precond=jacobi_preconditioner(diag),
                      rtol=1e-10, maxiter=5000)
    M = block_jacobi_preconditioner(A, 3)
    x2, s2 = cg_solve(op, b, precond=M, rtol=1e-10, maxiter=5000)
    assert bool(s1.converged) and bool(s2.converged)
    assert np.allclose(np.asarray(x1), np.asarray(x2), atol=1e-6)
    # point-block Jacobi should not be worse than scalar Jacobi
    assert int(s2.iters) <= int(s1.iters) + 2, (int(s1.iters), int(s2.iters))


def test_block_jacobi_is_exact_blockdiag_inverse():
    A, _ = _elasticity_system()
    M = block_jacobi_preconditioner(A, 3)
    # applying M to the columns of the block-diagonal reproduces identity
    n = A.n_rows
    from pfemfort_jax.solve.precond import _block_diag_from_dia
    blocks = np.asarray(_block_diag_from_dia(A, 3))  # (3, 3, nb)
    rng = np.random.default_rng(3)
    r = rng.standard_normal(n)
    z = np.asarray(M(jnp.asarray(r)))
    # check per-block: B @ z_block == r_block
    for k in range(min(10, n // 3)):
        B = blocks[:, :, k]
        assert np.allclose(B @ z[3 * k:3 * k + 3], r[3 * k:3 * k + 3],
                           atol=1e-8)


def test_chebyshev_preconditioner_beats_jacobi(tet10):
    """The matrix-free ILU-class option (solve/precond.py:
    chebyshev_preconditioner): markedly fewer CG iterations than scalar
    Jacobi on the reference's tet10 fixture, same solution."""
    import numpy as np

    from pfemfort_jax.drivers.poisson import solve_poisson

    mesh, dbc, _ = tet10
    rj = solve_poisson(mesh, dbc, rtol=1e-10)
    rc = solve_poisson(mesh, dbc, rtol=1e-10, precond="cheby")
    assert bool(np.asarray(rc.stats.converged))
    assert np.abs(rj.u_full - rc.u_full).max() < 1e-8
    assert int(rc.stats.iters) < 0.7 * int(rj.stats.iters), (
        int(rc.stats.iters), int(rj.stats.iters))


def test_ic0_preconditioner_beats_jacobi(tet10):
    """IC(0) + truncated-Neumann application (solve/ic0.py) — the
    reference's serial PC=ILU (triapoissonserialimpl1.F:696) for SPD
    systems: markedly fewer CG iterations than scalar Jacobi on the tet10
    fixture, same solution, and the route is recorded in timings."""
    import numpy as np

    from pfemfort_jax.drivers.poisson import solve_poisson

    mesh, dbc, _ = tet10
    rj = solve_poisson(mesh, dbc, rtol=1e-10)
    ri = solve_poisson(mesh, dbc, rtol=1e-10, precond="ic0")
    assert bool(np.asarray(ri.stats.converged))
    assert ri.timings["precond_used"] == "ic0"
    assert np.abs(rj.u_full - ri.u_full).max() < 1e-8
    assert int(ri.stats.iters) < 0.7 * int(rj.stats.iters), (
        int(ri.stats.iters), int(rj.stats.iters))


def test_ic0_factor_exact_on_tridiag():
    """On a tridiagonal SPD matrix IC(0) IS the exact Cholesky factor: the
    python and native backends must both reproduce L L^T = A."""
    import numpy as np

    from pfemfort_jax.solve.ic0 import _ic0_python

    n = 50
    rng = np.random.default_rng(0)
    main = 4.0 + rng.random(n)
    off = -1.0 + 0.1 * rng.random(n - 1)
    A = np.diag(main) + np.diag(off, -1) + np.diag(off, 1)
    # lower CSR incl diag
    lp, li, lv = [0], [], []
    for i in range(n):
        if i > 0:
            li.append(i - 1)
            lv.append(off[i - 1])
        li.append(i)
        lv.append(main[i])
        lp.append(len(li))
    lp = np.asarray(lp, np.int64)
    li32 = np.asarray(li, np.int32)

    results = []
    lv_py = np.asarray(lv, np.float64)
    _ic0_python(lp, li32.astype(np.int64), lv_py)
    results.append(lv_py)
    try:
        from pfemfort_jax import native

        if native.available():
            lv_nat = np.ascontiguousarray(lv, dtype=np.float64)
            if native.ic0(lp, li32, lv_nat) is not None:
                results.append(lv_nat)
    except Exception:
        pass
    for lv_f in results:
        L = np.zeros((n, n))
        for i in range(n):
            for p in range(lp[i], lp[i + 1]):
                L[i, li[p]] = lv_f[p]
        np.testing.assert_allclose(L @ L.T, A, atol=1e-12)
