"""Distributed geometric multigrid (parallel/dist_mg.py): sharded fine level
+ replicated coarse tail must match the manufactured solution, stay
mesh-independent in iterations, and be reachable through the driver
(solve_implicit_sharded(precond="mg"))."""

import jax
import numpy as np
import pytest

from pfemfort_jax.drivers.sharded import solve_implicit_sharded
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh import generate
from pfemfort_jax.parallel.dist_mg import solve_sharded_mg

POISSON = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)


def _mesh_or_skip(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("shard",))


@pytest.mark.parametrize("n_shards", [4, 8])
def test_dist_mg_manufactured_solution(n_shards):
    dm = _mesh_or_skip(n_shards)
    mesh, dbc = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 16)
    u, stats, timings = solve_sharded_mg(
        mesh, 1, dbc, POISSON, device_mesh=dm, rtol=1e-8, maxiter=60)
    assert bool(np.asarray(stats.converged)), stats
    assert int(np.asarray(stats.iters)) <= 25
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(np.asarray(u)[: mesh.n_node] - u_exact).max() < 5e-5
    assert timings["distributed_mg"]


def test_dist_mg_uneven_planes():
    """nnz_true not divisible by n_shards: last shard holds padding planes."""
    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 10)
    u, stats, _ = solve_sharded_mg(
        mesh, 1, dbc, POISSON, device_mesh=dm, rtol=1e-8, maxiter=60)
    assert bool(np.asarray(stats.converged)), stats
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(np.asarray(u)[: mesh.n_node] - u_exact).max() < 5e-5


def test_dist_mg_mesh_independent_iterations():
    """Iteration counts must stay ~constant under refinement (the multigrid
    property; Jacobi-CG would roughly double)."""
    dm = _mesh_or_skip(4)
    iters = []
    for n in (8, 16):
        mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
        _, stats, _ = solve_sharded_mg(
            mesh, 1, dbc, POISSON, device_mesh=dm, rtol=1e-8, maxiter=80)
        assert bool(np.asarray(stats.converged))
        iters.append(int(np.asarray(stats.iters)))
    assert iters[1] <= iters[0] + 4, iters


def test_dist_mg_elasticity_linear_field():
    """ndof=3: a linear displacement field imposed on every boundary node
    is exactly representable — the distributed MG-CG must reproduce it, and
    the ndof-aware smoothing (nu=2, omega=0.6) keeps iterations low."""
    import jax.numpy as jnp

    from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness

    dm = _mesh_or_skip(4)
    mesh, _ = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
    bnodes = generate.boundary_nodes(mesh)
    U = lambda X: np.stack([0.1 * X[:, 0],
                            0.05 * X[:, 1] + 0.02 * X[:, 0],
                            -0.03 * X[:, 2]], axis=1)
    ub = U(mesh.coords[bnodes])
    dbc = np.concatenate([
        np.stack([bnodes, np.full(len(bnodes), d), ub[:, d]], axis=1)
        for d in range(3)])
    efn = lambda c: elasticity_stiffness(c, "tetra4", dmat_3d(210.0, 0.3))
    u, stats, _ = solve_sharded_mg(mesh, 3, dbc, efn, device_mesh=dm,
                                   rtol=1e-9, maxiter=40,
                                   dtype=jnp.float64)
    assert bool(np.asarray(stats.converged)), stats
    assert int(np.asarray(stats.iters)) <= 25, stats
    ue = U(mesh.coords).reshape(-1)
    assert np.abs(np.asarray(u) - ue).max() < 1e-9


def test_driver_routes_precond_mg():
    """solve_implicit_sharded(precond='mg') must reach the distributed
    MG."""
    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 8, 0, 1, 8, 0, 1, 8)
    res = solve_implicit_sharded(mesh, 1, dbc, POISSON, device_mesh=dm,
                                 rtol=1e-8, maxiter=60, precond="mg")
    assert res.timings.get("distributed_mg"), res.timings
    assert bool(np.asarray(res.stats.converged))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 5e-5
    # BC rows carry the exact f64 applied values
    bnodes = generate.boundary_nodes(mesh)
    assert np.abs(res.u_full[bnodes] - u_exact[bnodes]).max() == 0.0


def test_driver_mg_falls_back_on_unstructured():
    """Non-lattice meshes can't coarsen geometrically: precond='mg' must
    degrade to the (block-)Jacobi distributed CG, not fail."""
    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 7)  # odd nez
    res = solve_implicit_sharded(mesh, 1, dbc, POISSON, device_mesh=dm,
                                 rtol=1e-10, maxiter=500, precond="mg")
    assert not res.timings.get("distributed_mg")
    assert bool(np.asarray(res.stats.converged))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-7


def test_dist_mg_chebyshev_coarse_tail():
    """A coarse chain stuck above the dense-inverse cap takes the Chebyshev
    tail: dist_gmg_preconditioner must build coarse_apply from
    meta.coarse_cheby (a (1,1) coarse_inv placeholder would TypeError at
    trace time and silently crash precond='mg' solves)."""
    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 12, 0, 1, 12, 0, 1, 12)
    u, stats, _ = solve_sharded_mg(
        mesh, 1, dbc, POISSON, device_mesh=dm, rtol=1e-8, maxiter=60,
        coarsest_max_dof=50)   # force the 4^3-lattice tail above the cap
    assert bool(np.asarray(stats.converged)), stats
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(np.asarray(u)[: mesh.n_node] - u_exact).max() < 5e-5
