"""Smoothed-aggregation AMG (solve/amg.py): the PC=hypre/gamg options-file
escape hatch (solverpetsc.F:198-209) for meshes with NO lattice structure —
mesh-independent iteration counts where Jacobi grows as O(n)."""

import jax
import numpy as np
import pytest

from pfemfort_jax.drivers.common import solve_implicit
from pfemfort_jax.elements.poisson import poisson_element_matrices

POISSON = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)


def _scrambled(n, seed=0):
    from pfemfort_jax.mesh import generate

    mesh, dbc = generate.box_tet(0, 1, n, 0, 1, n, 0, 1, n)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


def test_amg_mesh_independent_iterations():
    its = {}
    for n in (16, 24):
        mesh, dbc = _scrambled(n)
        res = solve_implicit(mesh, 1, dbc, POISSON, rtol=1e-10,
                             recover=False, precond="amg")
        assert res.timings["precond_used"] == "amg"
        err = np.abs(res.u_full - (mesh.coords ** 2).sum(axis=1)).max()
        assert err < 1e-6
        its[n] = int(np.asarray(res.stats.iters))
    # multigrid property: iterations ~constant under refinement
    assert its[24] <= its[16] + 4, its
    # and far below Jacobi's O(n) class (121 iters at n=24)
    assert its[24] <= 30, its


def test_amg_on_delaunay_mesh():
    """A genuinely unstructured Delaunay tetrahedralization: AMG must
    converge in far fewer iterations than Jacobi with the same solution."""
    from scipy.spatial import Delaunay

    from pfemfort_jax.mesh.core import Mesh

    rng = np.random.default_rng(2)
    n = 12       # > coarsest_max rows so the hierarchy actually builds
    g = np.linspace(0, 1, n + 1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)
    interior = ((pts > 1e-9) & (pts < 1 - 1e-9)).all(axis=1)
    pts[interior] += rng.uniform(-0.25, 0.25, (int(interior.sum()), 3)) / n
    tri = Delaunay(pts)
    conn = tri.simplices.astype(np.int64)
    a, b, c, d = (pts[conn[:, i]] for i in range(4))
    vol6 = np.einsum("ij,ij->i", np.cross(b - a, c - a), d - a)
    conn[vol6 < 0] = conn[vol6 < 0][:, [0, 2, 1, 3]]
    conn = conn[np.abs(vol6) > 1e-12]
    mesh = Mesh("tetra4", pts, conn.astype(np.int32))
    hull = np.unique(tri.convex_hull)
    u_ex = (pts ** 2).sum(axis=1)
    dbc = np.stack([hull, np.zeros(len(hull)), u_ex[hull]], axis=1)

    rj = solve_implicit(mesh, 1, dbc, POISSON, rtol=1e-10, precond="jacobi")
    ra = solve_implicit(mesh, 1, dbc, POISSON, rtol=1e-10, precond="amg")
    assert ra.timings["precond_used"] == "amg"
    assert bool(np.asarray(ra.stats.converged))
    assert int(ra.stats.iters) < 0.5 * int(rj.stats.iters), (
        int(ra.stats.iters), int(rj.stats.iters))
    assert np.abs(ra.u_full - rj.u_full).max() < 1e-7


def test_native_aggregation_matches_python():
    from pfemfort_jax import native
    from pfemfort_jax.solve import amg as amg_mod

    if not native.available():
        pytest.skip("native library not built")
    rng = np.random.default_rng(3)
    n = 500
    import scipy.sparse as ssp

    ii = rng.integers(0, n, 4000)
    jj = rng.integers(0, n, 4000)
    keep = ii != jj
    S = ssp.csr_matrix((np.ones(keep.sum(), np.float32),
                        (ii[keep], jj[keep])), shape=(n, n))
    S = ((S + S.T) > 0).astype(np.float32).tocsr()
    agg_n, na_n = native.samg_aggregate(S.indptr, S.indices, n)
    orig = native.samg_aggregate
    native.samg_aggregate = lambda *a, **k: None
    try:
        agg_p, na_p = amg_mod._aggregate(S.indptr,
                                         S.indices.astype(np.int64), n)
    finally:
        native.samg_aggregate = orig
    assert na_n == na_p
    np.testing.assert_array_equal(agg_n, agg_p)


def test_options_file_gamg_maps_to_amg():
    from pfemfort_jax.config import SolverOptions

    o = SolverOptions.from_options("-ksp_type cg\n-pc_type gamg\n")
    assert o.pc_type == "amg"
    o2 = SolverOptions.from_options("-pc_type ilu\n")
    assert o2.pc_type == "ic0"


def _mesh_or_skip(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("shard",))


def test_distributed_amg_mesh_independent():
    """precond='amg' on the unstructured DISTRIBUTED path: sharded fine
    smoothing over the halo operator + replicated algebraic coarse tail —
    mesh-independent iterations across 4 shards where Jacobi grows O(n)."""
    from pfemfort_jax.drivers.sharded import solve_implicit_sharded

    dm = _mesh_or_skip(4)
    its = {}
    for n in (12, 20):
        mesh, dbc = _scrambled(n, seed=1)
        res = solve_implicit_sharded(mesh, 1, dbc, POISSON, device_mesh=dm,
                                     rtol=1e-10, recover=False,
                                     precond="amg")
        assert res.timings["assembly_layout"] == "ell", res.timings
        assert res.timings["precond_used"] == "amg"
        assert bool(np.asarray(res.stats.converged))
        err = np.abs(res.u_full - (mesh.coords ** 2).sum(axis=1)).max()
        assert err < 1e-6
        its[n] = int(np.asarray(res.stats.iters))
    assert its[20] <= its[12] + 4, its
    assert its[20] <= 30, its


def test_distributed_amg_elasticity():
    """ndof=3 through the distributed AMG (dof-granular aggregation): must
    converge markedly faster than Jacobi with the same solution."""
    from pfemfort_jax.drivers.sharded import solve_implicit_sharded
    from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness
    from pfemfort_jax.mesh import generate

    dm = _mesh_or_skip(4)
    mesh, _ = generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 10)
    perm = np.random.default_rng(2).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    bnodes = generate.boundary_nodes(mesh)
    U = lambda X: np.stack([0.1 * X[:, 0], 0.05 * X[:, 1],
                            -0.03 * X[:, 2]], axis=1)
    ub = U(mesh.coords[bnodes])
    dbc = np.concatenate([
        np.stack([bnodes, np.full(len(bnodes), d), ub[:, d]], axis=1)
        for d in range(3)])
    efn = lambda c: elasticity_stiffness(c, "tetra4", dmat_3d(210.0, 0.3))
    runs = {}
    for pc in ("jacobi", "amg"):
        res = solve_implicit_sharded(mesh, 3, dbc, efn, device_mesh=dm,
                                     rtol=1e-10, recover=False, precond=pc)
        assert bool(np.asarray(res.stats.converged))
        runs[pc] = res
    ue = U(mesh.coords).reshape(-1)
    assert np.abs(runs["amg"].u_full - ue).max() < 1e-7
    # rigid-body near-nullspace + ndof-aware smoothing: 16 vs 67 measured
    assert (int(runs["amg"].stats.iters)
            < 0.4 * int(runs["jacobi"].stats.iters)), (
        int(runs["amg"].stats.iters), int(runs["jacobi"].stats.iters))


def test_distributed_amg_shard_count_invariant():
    """The sharded P^T restriction (local segment-sum + psum of the coarse
    residual — solve/amg.py:dist_samg_preconditioner) is the SAME operator
    at any shard count: 1-vs-8-shard solves must agree in solution and in
    iteration count up to roundoff reassociation."""
    from pfemfort_jax.drivers.sharded import solve_implicit_sharded

    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 devices")
    mesh, dbc = _scrambled(14, seed=3)
    res = {}
    for ns in (1, 8):
        dm = jax.sharding.Mesh(np.array(devs[:ns]), ("shard",))
        r = solve_implicit_sharded(mesh, 1, dbc, POISSON, device_mesh=dm,
                                   rtol=1e-10, recover=False,
                                   precond="amg")
        assert r.timings["precond_used"] == "amg"
        assert bool(np.asarray(r.stats.converged))
        res[ns] = r
    assert abs(int(np.asarray(res[1].stats.iters))
               - int(np.asarray(res[8].stats.iters))) <= 2
    np.testing.assert_allclose(res[1].u_full, res[8].u_full,
                               atol=5e-8, rtol=0)
