"""Multi-device tests on the 8-way virtual CPU mesh: 1-shard vs N-shard
solutions must agree (SURVEY §4's 1-vs-N equality requirement)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.mesh import generate
from pfemfort_jax.parallel.partition import (
    dual_graph,
    greedy_graph_partition,
    partition_elements,
    rcb_partition,
)
from pfemfort_jax.parallel.shard import build_sharded_system
from pfemfort_jax.parallel.shard_cg import distributed_cg_solve, shard_arrays
from pfemfort_jax.assembly.assemble import (
    assemble_ell_values,
    assemble_rhs,
    dirichlet_rhs_correction,
)
from pfemfort_jax.elements.poisson import poisson_element_matrices


def _devices_mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices, have {len(devs)}")
    return jax.sharding.Mesh(np.array(devs[:n]), ("shard",))


def test_rcb_balance():
    pts = np.random.default_rng(0).uniform(size=(1000, 3))
    for k in (2, 3, 8):
        part = rcb_partition(pts, k)
        counts = np.bincount(part, minlength=k)
        assert counts.min() > 0
        assert counts.max() - counts.min() <= len(pts) // k // 2 + 2


def test_greedy_partition_covers():
    mesh = generate.rect_tria(0, 1, 6, 0, 1, 6)
    indptr, adj = dual_graph(mesh)
    part = greedy_graph_partition(indptr, adj, 4)
    assert set(np.unique(part)) <= set(range(4))
    assert (np.bincount(part, minlength=4) > 0).all()


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_cg_matches_single_device(n_shards):
    device_mesh = _devices_mesh(n_shards)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)

    # single-device reference
    res = solve_poisson(mesh, dbc, rtol=1e-11)
    assert res.stats.converged

    # sharded system
    sys_ = build_sharded_system(mesh, 1, dbc, n_shards, layout='ell')
    from pfemfort_jax.elements.geometry import to_element_minor
    coords_e = jnp.asarray(to_element_minor(mesh.elem_coords()))
    Ke, Fe_src = poisson_element_matrices(coords_e, "tetra4", source=-6.0)
    A = assemble_ell_values(Ke, sys_.pattern,
                            jnp.asarray(sys_.pattern.ell_cols))
    ubc_e = jnp.asarray(
        sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof].T)
    b = assemble_rhs(Fe_src + dirichlet_rhs_correction(Ke, ubc_e),
                     sys_.pattern)

    cols_s, vals_s, b_s = shard_arrays(device_mesh, "shard",
                                       A.cols, A.vals, b)
    x, stats = distributed_cg_solve(device_mesh, cols_s, vals_s, b_s,
                                    rtol=1e-11)
    assert bool(np.asarray(stats.converged))
    x_orig = sys_.reduce_solution(np.asarray(x))
    assert np.allclose(x_orig, np.asarray(res.u_reduced), atol=1e-8)


def test_sharded_iteration_count_close_to_serial():
    """Jacobi-CG iteration count must not depend on the sharding."""
    device_mesh = _devices_mesh(4)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    res = solve_poisson(mesh, dbc, rtol=1e-10)

    sys_ = build_sharded_system(mesh, 1, dbc, 4, layout='ell')
    from pfemfort_jax.elements.geometry import to_element_minor
    coords_e = jnp.asarray(to_element_minor(mesh.elem_coords()))
    Ke, Fe_src = poisson_element_matrices(coords_e, "tetra4", source=-6.0)
    A = assemble_ell_values(Ke, sys_.pattern,
                            jnp.asarray(sys_.pattern.ell_cols))
    ubc_e = jnp.asarray(sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof].T)
    b = assemble_rhs(Fe_src + dirichlet_rhs_correction(Ke, ubc_e),
                     sys_.pattern)
    cols_s, vals_s, b_s = shard_arrays(device_mesh, "shard",
                                       A.cols, A.vals, b)
    x, stats = distributed_cg_solve(device_mesh, cols_s, vals_s, b_s,
                                    rtol=1e-10)
    assert abs(int(np.asarray(stats.iters)) - int(res.stats.iters)) <= 2
