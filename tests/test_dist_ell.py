"""Unstructured distributed assembly (parallel/dist_ell.py): per-shard ELL
blocks + one all_to_all ghost exchange must reproduce the replicated
assembly exactly and solve the reference's unstructured fixtures 1-vs-N.

Reference behavior being matched: element-ownership assembly on ANY
METIS-partitioned mesh (/root/reference/src/triapoissonparallelimpl1.F:
849-905) with the PETSc stash exchange (solverpetsc.F:447-468).
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
    assemble_implicit_sharded_ell,
    solve_implicit_sharded,
)
from pfemfort_jax.elements.elasticity import dmat_3d, elasticity_stiffness
from pfemfort_jax.elements.geometry import to_element_minor
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh import generate
from pfemfort_jax.parallel.dist_ell import build_dist_ell_setup

POISSON = lambda c: poisson_element_matrices(c, "tetra4", source=-6.0)


def _mesh_or_skip(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"needs {n} devices")
    return jax.sharding.Mesh(np.array(devs[:n]), ("shard",))


def _scrambled_box(nx=5, ny=5, nz=8, seed=0):
    mesh, dbc = generate.box_tet(0, 1, nx, 0, 1, ny, 0, 1, nz)
    perm = np.random.default_rng(seed).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    return mesh, dbc


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_assembly_matches_replicated_oracle(n_shards):
    """Sharded ELL values/rhs == replicated assembly on the same pattern."""
    dm = _mesh_or_skip(n_shards)
    mesh, dbc = _scrambled_box()
    setup = build_dist_ell_setup(mesh, 1, dbc, n_shards)
    vals_s, b_s = assemble_implicit_sharded_ell(
        setup, POISSON, dm, jnp.float64)

    sys_ = setup.sys
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))
    ubc_e = jnp.asarray(
        sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof].T)
    Ke, Fe_src = POISSON(coords_em)
    A = assemble_matrix(Ke, sys_.pattern)
    b = assemble_rhs(Fe_src + dirichlet_rhs_correction(Ke, ubc_e),
                     sys_.pattern)
    np.testing.assert_allclose(np.asarray(vals_s), np.asarray(A.vals),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(b_s), np.asarray(b), atol=1e-12)


def test_every_shard_owns_elements_and_ghosts_are_small():
    mesh, dbc = _scrambled_box(6, 6, 12)
    setup = build_dist_ell_setup(mesh, 1, dbc, 8)
    counts = np.bincount(setup.elem_owner, minlength=8)
    assert (counts > 0).all()
    assert setup.emax <= 2 * mesh.n_elem / 8
    # ghost windows stay a small fraction of a shard's own rows (surface
    # vs volume) — the point of element-partitioned assembly
    assert setup.w_mat <= setup.rows_per_shard * setup.ell_k
    assert setup.w_rhs <= setup.rows_per_shard


def test_ell_halo_spmv_matches_gather():
    """The pairwise ghost-exchange SpMV (spmv_ell_halo) == the plain global
    gather SpMV, and its exchange window is O(surface)."""
    from jax.sharding import PartitionSpec as P
    from pfemfort_jax.parallel.dist_ell import build_ell_halo, spmv_ell_halo
    from pfemfort_jax.sparse.spmv import spmv_ell
    from pfemfort_jax.sparse.formats import ELLMatrix

    dm = _mesh_or_skip(4)
    mesh, dbc = _scrambled_box(6, 6, 10, seed=2)
    setup = build_dist_ell_setup(mesh, 1, dbc, 4)
    vals_s, _ = assemble_implicit_sharded_ell(setup, POISSON, dm,
                                              jnp.float64)
    sys_ = setup.sys
    S, Prow, K = 4, sys_.rows_per_shard, setup.ell_k
    cols_local, send_rows, wx = build_ell_halo(setup)
    assert wx < Prow                      # surface, not volume

    A = ELLMatrix(cols=jnp.asarray(sys_.pattern.ell_cols),
                  vals=vals_s, n_cols=sys_.n_rows_padded)
    x = jnp.asarray(np.random.default_rng(0).normal(
        size=sys_.n_rows_padded))
    y_ref = spmv_ell(A, x)

    def body(vals_l, cols_l, sr_l, x_l):
        return spmv_ell_halo(vals_l, cols_l, sr_l, x_l, "shard")

    y = jax.jit(jax.shard_map(
        body, mesh=dm,
        in_specs=(P("shard", None),) * 3 + (P("shard"),),
        out_specs=P("shard")))(
        vals_s, jnp.asarray(cols_local.reshape(S * Prow, K)),
        jnp.asarray(send_rows.reshape(S * S, wx)), x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref),
                               atol=1e-12)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_solve_matches_single_device(n_shards, tet10):
    dm = _mesh_or_skip(n_shards)
    mesh, dbc, _ = tet10
    ref = solve_poisson(mesh, dbc, rtol=1e-11)
    res = solve_implicit_sharded(mesh, 1, dbc, POISSON,
                                 device_mesh=dm, rtol=1e-11)
    # tet10 is the generator's lattice box, so DIA per-shard assembly may
    # claim it — either way assembly must be DISTRIBUTED, never replicated
    assert res.timings["distributed_assembly"], res.timings
    assert np.allclose(res.u_full, ref.u_full, atol=1e-8)
    assert abs(int(res.stats.iters) - int(ref.stats.iters)) <= 2


@pytest.mark.parametrize("scramble", [False, True])
def test_beam_elasticity_with_force_bc(beam3d, scramble):
    """The reference's beam3Dtet6366 fixture (unstructured tets, ndof=3,
    nodal point load) through the distributed path.  scramble=True permutes
    the node numbering to force the general ELL + all_to_all route."""
    dm = _mesh_or_skip(4)
    mesh, dbc, fbc = beam3d
    if scramble:
        perm = np.random.default_rng(1).permutation(mesh.n_node)
        mesh = mesh.renumbered(perm.astype(np.int64))
        dbc = dbc.copy()
        dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
        fbc = fbc.copy()
        fbc[:, 0] = perm[fbc[:, 0].astype(np.int64)]
    E_, nu_ = 240.565, 0.3
    efn = lambda c: elasticity_stiffness(c, "tetra4", dmat_3d(E_, nu_))

    from pfemfort_jax.drivers.elasticity import solve_elasticity
    ref = solve_elasticity(mesh, dbc, E_, nu_, force_bc=fbc, rtol=1e-11)

    # recover=False pins the general ELL route (recovery would renumber
    # the scrambled mesh back to a DIA-able ordering)
    res = solve_implicit_sharded(mesh, 3, dbc, efn, device_mesh=dm,
                                 force_bc=fbc, rtol=1e-11, recover=False)
    if scramble:
        assert res.timings["assembly_layout"] == "ell", res.timings
    assert res.timings["distributed_assembly"], res.timings
    assert bool(np.asarray(res.stats.converged))
    scale = np.abs(ref.u_full).max()
    assert np.abs(res.u_full - ref.u_full).max() < 1e-8 * max(scale, 1.0)


def test_bjacobi_beats_jacobi_on_scrambled_elasticity(beam3d):
    """precond='bjacobi' on the unstructured distributed path (node-block
    Jacobi from the per-shard ELL, the reference default PC,
    solverpetsc.F:206) must be honored — measurably fewer iterations than
    scalar Jacobi — and recorded in timings (no silent degradation)."""
    dm = _mesh_or_skip(4)
    mesh, dbc, fbc = beam3d
    perm = np.random.default_rng(3).permutation(mesh.n_node)
    mesh = mesh.renumbered(perm.astype(np.int64))
    dbc = dbc.copy()
    dbc[:, 0] = perm[dbc[:, 0].astype(np.int64)]
    fbc = fbc.copy()
    fbc[:, 0] = perm[fbc[:, 0].astype(np.int64)]
    efn = lambda c: elasticity_stiffness(c, "tetra4", dmat_3d(240.565, 0.3))

    runs = {}
    for pc in ("jacobi", "bjacobi"):
        res = solve_implicit_sharded(mesh, 3, dbc, efn, device_mesh=dm,
                                     force_bc=fbc, rtol=1e-10,
                                     recover=False, precond=pc)
        assert res.timings["assembly_layout"] == "ell", res.timings
        assert res.timings["precond_requested"] == pc
        assert res.timings["precond_used"] == pc
        assert bool(np.asarray(res.stats.converged))
        runs[pc] = res
    it_j = int(np.asarray(runs["jacobi"].stats.iters))
    it_b = int(np.asarray(runs["bjacobi"].stats.iters))
    assert it_b < it_j, (it_b, it_j)
    scale = max(np.abs(runs["jacobi"].u_full).max(), 1.0)
    assert np.abs(runs["bjacobi"].u_full
                  - runs["jacobi"].u_full).max() < 1e-7 * scale


def test_mg_refusal_is_recorded():
    """precond='mg' on a non-coarsenable mesh must record the refusal reason
    and the preconditioner actually used."""
    dm = _mesh_or_skip(4)
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 7)  # odd nez
    res = solve_implicit_sharded(mesh, 1, dbc, POISSON, device_mesh=dm,
                                 rtol=1e-8, precond="mg")
    assert res.timings["precond_requested"] == "mg"
    assert res.timings["precond_used"] == "jacobi"
    assert "coarsen" in res.timings["mg_refused"]
    assert bool(np.asarray(res.stats.converged))


def test_per_shard_ic0_beats_jacobi():
    """precond='ic0' on the distributed ELL path = PC=BJACOBI with one
    IC(0) sub-factorization per shard (the reference's ACTUAL parallel
    default: block-Jacobi's default sub-PC is ILU, solverpetsc.F:206).
    Must markedly beat scalar Jacobi and record the route."""
    dm = _mesh_or_skip(4)
    mesh, dbc = _scrambled_box(8, 8, 12, seed=4)
    its = {}
    for pc in ("jacobi", "ic0"):
        res = solve_implicit_sharded(mesh, 1, dbc, POISSON, device_mesh=dm,
                                     rtol=1e-10, recover=False, precond=pc)
        assert res.timings["assembly_layout"] == "ell", res.timings
        assert res.timings["precond_used"] == pc
        assert bool(np.asarray(res.stats.converged))
        err = np.abs(res.u_full - (mesh.coords ** 2).sum(axis=1)).max()
        assert err < 1e-6
        its[pc] = int(np.asarray(res.stats.iters))
    assert its["ic0"] < 0.7 * its["jacobi"], its


def test_delaunay_mesh_distributed_ell():
    """A genuinely unstructured Delaunay tet mesh (no recoverable lattice)
    through the distributed per-shard ELL path with the per-shard IC(0)
    preconditioner — matches the single-device solve."""
    from scipy.spatial import Delaunay

    from pfemfort_jax.mesh.core import Mesh

    dm = _mesh_or_skip(4)
    rng = np.random.default_rng(1)
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
    conn = conn[np.abs(vol6) > 1e-12]
    # scramble the node numbering: the meshgrid order would pass the DIA
    # census even for this mesh (near-stencil offsets); the scrambled ids
    # pin the general ELL + all_to_all route
    perm = rng.permutation(len(pts))
    inv = np.empty(len(pts), np.int64)
    inv[perm] = np.arange(len(pts))
    pts = pts[perm]
    conn = inv[conn]
    mesh = Mesh("tetra4", pts, conn.astype(np.int32))
    hull = np.unique(inv[np.unique(tri.convex_hull)])
    u_ex = (pts ** 2).sum(axis=1)
    dbc = np.stack([hull, np.zeros(len(hull)), u_ex[hull]], axis=1)

    ref = solve_poisson(mesh, dbc, rtol=1e-11)
    res = solve_implicit_sharded(mesh, 1, dbc, POISSON, device_mesh=dm,
                                 rtol=1e-11, precond="ic0")
    assert res.timings["assembly_layout"] == "ell", res.timings
    assert res.timings["precond_used"] == "ic0"
    assert bool(np.asarray(res.stats.converged))
    scale = max(np.abs(ref.u_full).max(), 1.0)
    assert np.abs(res.u_full - ref.u_full).max() < 1e-8 * scale
