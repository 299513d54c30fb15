"""Halo-exchange DIA distributed CG: must match the single-device solve and
the all_gather path exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pfemfort_jax.drivers.poisson import solve_poisson
from pfemfort_jax.drivers.sharded import solve_implicit_sharded
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness
from pfemfort_jax.mesh import generate
from pfemfort_jax.parallel.partition import slab_partition


def _mesh_or_skip(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("shard",))


def test_slab_partition_is_contiguous():
    pts = np.random.default_rng(0).uniform(size=(500, 3)) * [1, 2, 10]
    part = slab_partition(pts, 4)
    counts = np.bincount(part, minlength=4)
    assert counts.max() - counts.min() <= 1
    # slabs are ordered along z (the longest axis)
    for p in range(3):
        assert pts[part == p, 2].max() <= pts[part == p + 1, 2].min() + 1e-12


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_halo_cg_matches_single_device_poisson(n_shards):
    dm = _mesh_or_skip(n_shards)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 6)
    ref = solve_poisson(mesh, dbc, rtol=1e-11)

    res = solve_implicit_sharded(
        mesh, 1, dbc,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        device_mesh=dm, rtol=1e-11)
    assert bool(np.asarray(res.stats.converged))
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)
    # iteration count must be sharding-independent
    assert abs(int(res.stats.iters) - int(ref.stats.iters)) <= 2


def test_halo_cg_elasticity_3d():
    dm = _mesh_or_skip(4)
    mesh, _ = generate.box_tet(0, 1, 3, 0, 1, 3, 0, 1, 6)
    base = np.nonzero(np.isclose(mesh.coords[:, 2], 0))[0]
    dbc = np.array([[n, d, 0.0] for n in base for d in (0, 1, 2)])
    D = dmat_3d(240.565, 0.3)
    tip = np.argmax(mesh.coords[:, 2])
    fbc = np.array([[tip, 0, 1.0]])

    from pfemfort_jax.drivers.elasticity import solve_elasticity
    ref = solve_elasticity(mesh, dbc, 240.565, 0.3, force_bc=fbc, rtol=1e-11)

    res = solve_implicit_sharded(
        mesh, 3, dbc,
        lambda c: elasticity_stiffness(c, "tetra4", D),
        force_bc=fbc, device_mesh=dm, rtol=1e-11)
    assert bool(np.asarray(res.stats.converged))
    assert np.allclose(res.u_full, ref.u_full, atol=1e-7)


def test_lattice_halo_spmv_matches_single_device():
    """The stencil form of the in-shard SpMV (spmv_dia_halo_lattice) must
    equal the single-device DIA SpMV exactly, and the slab sharding must
    make it eligible (plane-aligned shards + decomposable offsets)."""
    from pfemfort_jax.assembly.assemble import assemble_matrix
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.parallel.halo import (
        lattice_halo_plan, spmv_dia_halo_lattice)
    from pfemfort_jax.parallel.shard import build_sharded_system
    from pfemfort_jax.sparse.dia import spmv_dia
    from jax.sharding import PartitionSpec as P

    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 6, 0, 1, 7, 0, 1, 9)
    sys_ = build_sharded_system(mesh, 1, dbc, 4, method="slab")
    lat = sys_.pattern.dia_lattice
    assert lat is not None                      # sharding kept the lattice
    plane = int(np.prod(lat[1:]))
    assert sys_.rows_per_shard % plane == 0     # plane-aligned shards
    plan = lattice_halo_plan(sys_.pattern.dia_offsets, lat)
    assert plan is not None                     # offsets decompose
    shifts, wp = plan

    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))
    Ke, _ = poisson_element_matrices(coords_em, "tetra4", source=-6.0)
    A = assemble_matrix(Ke, sys_.pattern)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=sys_.n_rows_padded))
    y_ref = spmv_dia(A, x)

    def body(vals_l, x_l):
        return spmv_dia_halo_lattice(shifts, vals_l, x_l, lat, wp, "shard")

    y = jax.jit(jax.shard_map(
        body, mesh=dm,
        in_specs=(P(None, "shard"), P("shard")),
        out_specs=P("shard")))(A.vals, x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=1e-12)


def test_manufactured_solution_on_shards():
    dm = _mesh_or_skip(8)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
    res = solve_implicit_sharded(
        mesh, 1, dbc,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        device_mesh=dm, rtol=1e-11)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-8


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_distributed_krylov_menu_dia(method):
    """-ksp_type bicgstab/gmres on the sharded DIA path must match the
    single-device solve (the reference switches its MPI KSP the same way,
    solverpetsc.F:198)."""
    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 8)
    res = solve_implicit_sharded(
        mesh, 1, dbc,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        device_mesh=dm, rtol=1e-10, method=method)
    assert bool(np.asarray(res.stats.converged))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-6


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_distributed_krylov_menu_ell(method):
    """The same menu on the unstructured (scrambled, dist/ell) path."""
    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 5, 0, 1, 5, 0, 1, 6)
    perm = np.random.default_rng(7).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    res = solve_implicit_sharded(
        mesh, 1, dbc,
        lambda c: poisson_element_matrices(c, "tetra4", source=-6.0),
        device_mesh=dm, rtol=1e-10, method=method, recover=False)
    assert res.timings["assembly_layout"] == "ell", res.timings
    assert bool(np.asarray(res.stats.converged))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(res.u_full - u_exact).max() < 1e-6
