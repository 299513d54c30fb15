"""Distributed (per-shard) implicit assembly: the assembled operator and the
end-to-end solve must match the single-device replicated assembly exactly
(up to fp summation order), and per-device memory must stay O(E/S).

Reference behavior being matched: each rank assembles only its own elements
(/root/reference/src/triapoissonparallelimpl1.F:849-905), off-rank entries
exchanged at MatAssemblyBegin/End (solverpetsc.F:447-468).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.assembly.assemble import (
    assemble_matrix,
    assemble_rhs,
    dirichlet_rhs_correction,
)
from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.drivers.sharded import (
    assemble_implicit_sharded,
    solve_implicit_sharded,
)
from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness
from pfemfort_jax.elements.geometry import to_element_minor
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh import generate
from pfemfort_jax.parallel.dist_assembly import build_dist_setup


def _mesh_or_skip(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("shard",))


def _element_fn():
    return lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_dist_assembly_matches_replicated(n_shards):
    dm = _mesh_or_skip(n_shards)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4 * n_shards)

    setup = build_dist_setup(mesh, 1, dbc, n_shards)
    vals_s, b_s = assemble_implicit_sharded(
        setup, _element_fn(), dm, jnp.float64)

    # replicated oracle on the SAME shard-ordered pattern
    sys_ = setup.sys
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))
    ubc_e = jnp.asarray(
        sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof].T)
    Ke, Fe_src = _element_fn()(coords_em)
    A = assemble_matrix(Ke, sys_.pattern)
    b = assemble_rhs(Fe_src + dirichlet_rhs_correction(Ke, ubc_e),
                     sys_.pattern)

    assert setup.offsets == A.offsets
    np.testing.assert_allclose(np.asarray(vals_s), np.asarray(A.vals),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(b_s), np.asarray(b), atol=1e-12)


def test_every_shard_assembles_some_elements():
    # 4x4x32 reduced lattice -> 512 equations = exactly 64 rows/shard
    mesh, dbc = generate.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 33)
    setup = build_dist_setup(mesh, 1, dbc, 8)
    counts = np.bincount(setup.elem_owner, minlength=8)
    assert (counts > 0).all()
    # per-shard padding stays bounded: Emax <= 2x the mean
    assert setup.emax <= 2 * mesh.n_elem / 8


@pytest.mark.parametrize("n_shards", [2, 8])
def test_dist_solve_matches_single_device(n_shards):
    dm = _mesh_or_skip(n_shards)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4 * n_shards)
    ref = solve_poisson(mesh, dbc, rtol=1e-11)

    res = solve_implicit_sharded(mesh, 1, dbc, _element_fn(),
                                 device_mesh=dm, rtol=1e-11)
    assert res.timings["distributed_assembly"]
    assert bool(np.asarray(res.stats.converged))
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)


def test_dist_solve_elasticity_block_jacobi():
    """3D elasticity through the distributed path with PC=BJACOBI: converges
    to the same solution in FEWER iterations than scalar Jacobi."""
    dm = _mesh_or_skip(4)
    mesh, _ = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 16)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    D = dmat_3d(240.565, 0.3)
    tip = int(np.argmax(mesh.coords[:, 2]))
    fbc = np.array([[tip, 0, 1.0]])
    efn = lambda c: elasticity_stiffness(c, "tetra4", D)

    from pfemfort_jax.drivers.elasticity import solve_elasticity
    ref = solve_elasticity(mesh, dbc, 240.565, 0.3, force_bc=fbc,
                           rtol=1e-11)

    res_j = solve_implicit_sharded(mesh, 3, dbc, efn, device_mesh=dm,
                                   force_bc=fbc, rtol=1e-11,
                                   precond="jacobi")
    res_b = solve_implicit_sharded(mesh, 3, dbc, efn, device_mesh=dm,
                                   force_bc=fbc, rtol=1e-11,
                                   precond="bjacobi")
    for res in (res_j, res_b):
        assert bool(np.asarray(res.stats.converged))
        assert np.allclose(res.u_full, ref.u_full, atol=1e-7)
    assert int(res_b.stats.iters) < int(res_j.stats.iters)


def test_unstructured_routes_to_dist_ell():
    """Non-lattice meshes must use the per-shard ELL + all_to_all path
    (parallel/dist_ell.py), NOT the replicated fallback."""
    dm = _mesh_or_skip(2)
    mesh, dbc = generate.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 6)
    perm = np.random.default_rng(3).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    res = solve_implicit_sharded(mesh, 1, dbc, _element_fn(),
                                 device_mesh=dm, rtol=1e-10, recover=False)
    ref = solve_poisson(mesh, dbc, rtol=1e-10)
    assert res.timings["assembly_layout"] == "ell", res.timings
    assert res.timings["distributed_assembly"]
    assert bool(np.asarray(res.stats.converged))
    assert np.allclose(res.u_full, ref.u_full, atol=1e-7)
