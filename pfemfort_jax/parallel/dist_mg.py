"""Distributed geometric multigrid: sharded fine level + replicated coarse tail.

The reference's scalable-preconditioner story is PETSc's options-file escape
hatch to hypre/AMG (/root/reference/src/solverpetsc.F:1-8, 198-209) on top of
the MPI row-partitioned KSP CG (SURVEY §2.5).  This module combines this
framework's two strongest pieces into one solver — a
multi-chip MG-preconditioned CG on the generator lattice meshes:

  * the FULL node-dof system is slab-sharded over z-planes of the node
    lattice (rows stay lattice-ordered, so shard-contiguous ownership is a
    z-slab — the reference's contiguous row blocks,
    triapoissonparallelimpl1.F:536-667);
  * each shard assembles ONLY its own z-slab of elements with the
    scatter-free structured slice-add kernel (assembly/structured.py) and
    ships the one spill plane to its right neighbor with a single ppermute
    (the MatAssemblyBegin/End stash exchange, solverpetsc.F:447-468);
  * Dirichlet BCs are eliminated SYMMETRICALLY on-device (rows and columns
    to identity, u_bc moved to the rhs) so the sharded operator is SPD and
    one matrix serves both CG and the smoother;
  * the V-cycle's fine level runs sharded: Jacobi smoothing is elementwise,
    the residual SpMV is the halo-ppermute DIA kernel (parallel/halo.py),
    restriction/prolongation in z exchange ONE plane with a neighbor
    (y/x transfers are shard-local);
  * below the fine level the hierarchy is 8x smaller per level, so the
    restricted residual is all_gather'd once per V-cycle and the existing
    replicated V-cycle (solve/multigrid.py:_vcycle) runs the coarse tail
    redundantly on every device — per-device fine memory stays O(N/S) while
    the replicated tail is O(N/8).

Per preconditioner application the comms are: 2 halo SpMV exchanges +
2 one-plane transfer exchanges + 1 all_gather of N/2^ndim between devices.
Iteration counts stay mesh-independent (~10) where the reference's default
block-Jacobi CG grows as O(n) (solverpetsc.F:206).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from pfemfort_jax.assembly.structured import (
    StructuredPlan,
    build_structured_plan,
)
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.parallel.halo import exchange_halos, halo_width, spmv_dia_halo
from pfemfort_jax.solve.cg import SolveStats, cg_solve
from pfemfort_jax.solve.multigrid import (
    GMGArrays,
    GMGMeta,
    _coarse_box_mesh,
    _vcycle,
    build_gmg,
    interp_axis,
    restrict_axis,
)


@dataclasses.dataclass
class DistMGSetup:
    """Host-side geometry for the sharded fine level + the coarse tail."""
    n_shards: int
    ndof: int
    nnx: int
    nny: int
    nnz_true: int            # true node planes (nez + 1)
    planes_per_shard: int    # even; Ztot = S * planes_per_shard >= nnz_true
    offsets: Tuple[int, ...]
    w: int                   # flat halo width for the fine SpMV
    plan: StructuredPlan     # entries reused with local z-extents
    cells_per_shard: int     # z-cells assembled per shard (= planes_per_shard)
    coords_s: np.ndarray     # (S, npe, ndim, Ecap) element-minor
    validz_s: np.ndarray     # (S, planes_per_shard) 1.0 where the z-cell is real
    bc_mask_pad: np.ndarray  # (Ztot * plane_dofs,) bool (True on BC/padding)
    bc_vals_pad: np.ndarray  # (Ztot * plane_dofs,) float64
    coarse: Optional[Tuple[GMGArrays, GMGMeta]]
    nu: int
    omega: float

    @property
    def plane_dofs(self) -> int:
        return self.nny * self.nnx * self.ndof

    @property
    def rows_per_shard(self) -> int:
        return self.planes_per_shard * self.plane_dofs

    @property
    def n_rows_padded(self) -> int:
        return self.n_shards * self.rows_per_shard


def build_dist_mg_setup(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    n_shards: int,
    dtype=jnp.float32,
    nu: int = 1,
    omega: float = 0.8,
    coarsest_max_dof: int = 4096,
) -> DistMGSetup:
    """Slab the generator lattice into per-shard element blocks and build the
    replicated coarse hierarchy.  Raises ValueError when the mesh is not a
    coarsenable box_tet lattice (callers fall back to Jacobi/bjacobi CG)."""
    st = mesh.structure or {}
    if st.get("kind") != "box_tet":
        raise ValueError("distributed MG needs a box_tet generator mesh")
    nex, ney, nez = st["nex"], st["ney"], st["nez"]
    nnx, nny, nnz_true = nex + 1, ney + 1, nez + 1
    if any(d % 2 for d in (nex, ney, nez)):
        raise ValueError("odd cell counts cannot coarsen")

    # planes per shard: even (keeps shard starts on even global planes so
    # z-restriction alignment is uniform across shards)
    pp = -(-nnz_true // n_shards)
    pp += pp % 2
    plane_dofs = nny * nnx * ndof

    plan = build_structured_plan(nex, ney, nez, ndof=ndof)
    offsets = plan.offsets
    w = halo_width(offsets)
    if w > pp * plane_dofs:
        raise ValueError(f"halo {w} exceeds shard rows {pp * plane_dofs}")

    dofmap = build_dofmap(mesh, ndof, dirichlet)
    bc_mask = ~dofmap.free_mask_full()                  # (n_node*ndof,)
    bc_vals = dofmap.bc_values_full

    Ztot = n_shards * pp
    npad_rows = Ztot * plane_dofs
    bc_mask_pad = np.ones(npad_rows, dtype=bool)        # padding rows = BC(0)
    bc_vals_pad = np.zeros(npad_rows, dtype=np.float64)
    n_true = nnz_true * plane_dofs
    bc_mask_pad[:n_true] = bc_mask
    bc_vals_pad[:n_true] = bc_vals

    # per-shard element slabs (elements are z-major, 6 per hex, contiguous)
    npe, ndim = mesh.npe, mesh.ndim
    epp = ney * nex * 6                                 # elements per z-cell
    ecap = pp * epp
    c_t = np.ascontiguousarray(mesh.coords.T, dtype=np.dtype(dtype))
    coords_s = np.empty((n_shards, npe, ndim, ecap), dtype=c_t.dtype)
    validz_s = np.zeros((n_shards, pp), dtype=c_t.dtype)
    conn_t = mesh.conn.T                                # (npe, E)
    e0_coords = np.ascontiguousarray(
        c_t[:, conn_t[:, :1]]).transpose(1, 0, 2)       # (npe, ndim, 1)
    for s in range(n_shards):
        z0 = s * pp
        z1 = min(z0 + pp, nez)
        k = max(z1 - z0, 0) * epp
        coords_s[s] = e0_coords                         # broadcast fill
        if k:
            sl = conn_t[:, z0 * epp: z0 * epp + k]
            coords_s[s, :, :, :k] = np.ascontiguousarray(
                c_t[:, sl]).transpose(1, 0, 2)
            validz_s[s, :max(z1 - z0, 0)] = 1.0

    # replicated coarse tail: the existing GMG hierarchy built from level 1
    coarse_mesh, _ = _coarse_box_mesh(mesh)
    shape_f = (nnz_true, nny, nnx)
    bc_coarse = bc_mask.reshape(*shape_f, ndof)[::2, ::2, ::2].reshape(-1)
    coarse = build_gmg(coarse_mesh, ndof, bc_coarse, element_fn,
                       dtype=dtype, nu=nu, omega=omega,
                       coarsest_max_dof=coarsest_max_dof)
    if coarse is None:
        raise ValueError("coarse hierarchy construction failed")

    return DistMGSetup(
        n_shards=n_shards, ndof=ndof, nnx=nnx, nny=nny, nnz_true=nnz_true,
        planes_per_shard=pp, offsets=offsets, w=w, plan=plan,
        cells_per_shard=pp, coords_s=coords_s, validz_s=validz_s,
        bc_mask_pad=bc_mask_pad, bc_vals_pad=bc_vals_pad,
        coarse=coarse, nu=nu, omega=omega)


# ---------------------------------------------------------------------------
# device-side pieces (run INSIDE shard_map)
# ---------------------------------------------------------------------------

def _assemble_fine_shard(setup: DistMGSetup, element_fn, coords_em, validz,
                         bc_l, bcv_l, axis: str):
    """Per-shard structured assembly + one-plane spill + symmetric Dirichlet
    elimination.  Returns (vals_l (D, P), b_l (P,)) shard-local."""
    plan = setup.plan
    nex, ney = plan.nex, plan.ney
    nnx, nny = setup.nnx, setup.nny
    ndof = setup.ndof
    ns = 4 * ndof
    D = len(setup.offsets)
    pp = setup.planes_per_shard
    plane = setup.plane_dofs
    Prow = setup.rows_per_shard
    w = setup.w
    dtype = coords_em.dtype

    Ke, Fe = element_fn(coords_em)                     # (ns, ns, El), (ns, El)
    vmask = jnp.broadcast_to(
        validz[:, None, None, None], (pp, ney, nex, 6)).reshape(-1)
    Ke = Ke * vmask
    Fe = Fe * vmask

    acc = jnp.zeros((D, pp + 1, nny, nnx, ndof), dtype=dtype)
    rhs = jnp.zeros((pp + 1, nny, nnx, ndof), dtype=dtype)
    Kc = Ke.reshape(ns, ns, pp, ney, nex, 6)
    Fc = Fe.reshape(ns, pp, ney, nex, 6)
    for (c, nr, nc, d, rz, ry, rx, ci) in plan.entries:
        blk = Kc[nr, nc, :, :, :, c]
        acc = acc.at[d, rz:rz + pp, ry:ry + ney, rx:rx + nex, ci].add(blk)
    for (c, nr, rz, ry, rx, ci) in plan.rhs_entries:
        blk = Fc[nr, :, :, :, c]
        rhs = rhs.at[rz:rz + pp, ry:ry + ney, rx:rx + nex, ci].add(blk)

    # spill plane pp -> right neighbor's plane 0 (one deterministic ppermute:
    # the PETSc MatAssembly stash exchange)
    n = jax.lax.axis_size(axis)
    perm = [(i, i + 1) for i in range(n - 1)]
    recv_v = jax.lax.ppermute(acc[:, pp], axis, perm)
    recv_b = jax.lax.ppermute(rhs[pp], axis, perm)
    vals_l = acc[:, :pp].at[:, 0].add(recv_v).reshape(D, Prow)
    b_l = rhs[:pp].at[0].add(recv_b).reshape(Prow)

    # symmetric Dirichlet elimination: halo-shifted column masks/values
    bcf = bc_l.astype(dtype)
    ubc = jnp.where(bc_l, bcv_l, 0.0).astype(dtype)
    lm, rm = exchange_halos(bcf, w, axis)
    lv, rv = exchange_halos(ubc, w, axis)
    bc_ext = jnp.concatenate([lm, bcf, rm])
    ub_ext = jnp.concatenate([lv, ubc, rv])
    new_vals = []
    try:
        d0 = setup.offsets.index(0)
    except ValueError:
        d0 = -1
    for d, o in enumerate(setup.offsets):
        col_bc = jax.lax.slice_in_dim(bc_ext, w + o, w + o + Prow)
        col_ub = jax.lax.slice_in_dim(ub_ext, w + o, w + o + Prow)
        b_l = b_l - vals_l[d] * col_ub                 # move u_bc to the rhs
        v = jnp.where(col_bc > 0, 0.0, vals_l[d])      # zero BC columns
        if d == d0:
            v = jnp.where(bc_l, 1.0, v)                # identity BC rows
        else:
            v = jnp.where(bc_l, 0.0, v)
        new_vals.append(v)
    vals_l = jnp.stack(new_vals)
    b_l = jnp.where(bc_l, bcv_l.astype(dtype), b_l)
    return vals_l, b_l


def _restrict_shard(setup: DistMGSetup, r_lat, axis: str):
    """Shard-local 3-axis restriction; z needs the left neighbor's last odd
    plane.  r_lat: (pp, nny, nnx, ndof) -> (pp//2, nyc, nxc, ndof)."""
    f = restrict_axis(restrict_axis(r_lat, 1), 2)
    ev = f[0::2]
    od = f[1::2]
    n = jax.lax.axis_size(axis)
    left = jax.lax.ppermute(od[-1:], axis,
                            [(i, i + 1) for i in range(n - 1)])
    od_prev = jnp.concatenate([left, od[:-1]], axis=0)
    return ev + 0.5 * (od_prev + od)


def _prolong_shard(setup: DistMGSetup, ec_full, shard_idx):
    """Replicated full coarse correction -> this shard's fine slab (local).

    ec_full: (Zc_pad, nyc, nxc, ndof) with Zc_pad = Ztot//2 + 1 (zero-padded
    beyond the true coarse planes).  Returns (pp, nny, nnx, ndof)."""
    pp = setup.planes_per_shard
    ppc = pp // 2
    k0 = shard_idx * ppc
    ev = jax.lax.dynamic_slice_in_dim(ec_full, k0, ppc, axis=0)
    nxt = jax.lax.dynamic_slice_in_dim(ec_full, k0 + 1, ppc, axis=0)
    od = 0.5 * (ev + nxt)
    z = jnp.stack([ev, od], axis=1).reshape((pp,) + ev.shape[1:])
    return interp_axis(interp_axis(z, 1), 2)


def fine_spmv_factory(setup: DistMGSetup, vals_l, axis: str) -> Callable:
    """x_l -> (A x)_l for the sharded fine level: the N-D lattice-stencil
    sliced-window form, else 1-D shifted slices."""
    offsets, w = setup.offsets, setup.w
    Prow = setup.rows_per_shard
    from pfemfort_jax.parallel.halo import (
        lattice_halo_plan, spmv_dia_halo_lattice)

    lat = (setup.n_shards * setup.planes_per_shard, setup.nny,
           setup.nnx * setup.ndof)
    plan = lattice_halo_plan(offsets, lat)
    if plan is not None and plan[1] * setup.plane_dofs <= Prow:
        shifts, wp = plan
        return lambda x_l: spmv_dia_halo_lattice(shifts, vals_l, x_l, lat,
                                                 wp, axis)
    return lambda x_l: spmv_dia_halo(offsets, vals_l, x_l, w, axis)


def dist_gmg_preconditioner(setup: DistMGSetup, vals_l, inv_diag_l, mask_l,
                            coarse_arrays: GMGArrays, axis: str,
                            spmv: Optional[Callable] = None) -> Callable:
    """r_l -> M^{-1} r_l inside shard_map: sharded fine smoothing/transfers
    + the replicated coarse tail.  Build OUTSIDE the CG loop.  `spmv`: the
    fine-level shard-local operator (fine_spmv_factory); built here when
    not supplied."""
    meta_c = setup.coarse[1]
    pp = setup.planes_per_shard
    nny, nnx, ndof = setup.nny, setup.nnx, setup.ndof
    om = setup.omega
    offsets, w = setup.offsets, setup.w
    nnz_c = (setup.nnz_true - 1) // 2 + 1      # true coarse planes
    zc_pad = (setup.n_shards * pp) // 2 + 1
    nyc, nxc = (nny - 1) // 2 + 1, (nnx - 1) // 2 + 1
    # The coarse arrays are replicated (P() spec): each device runs the
    # coarse levels on its local copy.
    from pfemfort_jax.sparse.ops import matvec
    coarse_ops = tuple(matvec(A) for A in coarse_arrays.mats)

    # Chebyshev coarse tail when the coarsening chain sticks on an odd
    # dimension above the dense-inverse cap (build_gmg returns the
    # (1, 1) coarse_inv placeholder in that case — _vcycle must NOT use it)
    coarse_apply = None
    if meta_c.coarse_cheby is not None:
        from pfemfort_jax.solve.precond import chebyshev_preconditioner

        lmax, lmin, deg = meta_c.coarse_cheby
        inv_d = coarse_arrays.inv_diags[-1]
        diag_c = jnp.where(inv_d != 0, 1.0 / inv_d, 1.0)
        coarse_apply = chebyshev_preconditioner(
            coarse_ops[-1], diag_c, lmax=lmax, lmin=lmin, degree=deg)

    if spmv is None:
        spmv = fine_spmv_factory(setup, vals_l, axis)

    def precond(r_l):
        # keep the ORIGINAL r_l for the identity-on-BC return below (matching
        # gmg_preconditioner, solve/multigrid.py): the masked copy feeds the
        # cycle so the preconditioner stays SPD even for nonzero BC residuals
        rm = mask_l * r_l
        e = om * inv_diag_l * rm
        for _ in range(setup.nu - 1):
            e = e + om * inv_diag_l * (rm - spmv(e))

        r1 = (mask_l * (rm - spmv(e))).reshape(pp, nny, nnx, ndof)
        rc_l = _restrict_shard(setup, r1, axis)        # (pp//2, nyc, nxc, nd)
        rc_all = jax.lax.all_gather(rc_l, axis, tiled=True)
        rc = rc_all[:nnz_c].reshape(-1)                # replicated coarse r
        rc = coarse_arrays.masks[0] * rc
        ec = _vcycle(coarse_arrays, meta_c, 0, rc, coarse_ops, coarse_apply)

        ec_lat = ec.reshape(nnz_c, nyc, nxc, ndof)
        ec_pad = jnp.zeros((zc_pad, nyc, nxc, ndof), dtype=ec.dtype)
        ec_pad = ec_pad.at[:nnz_c].set(ec_lat)
        idx = jax.lax.axis_index(axis)
        e = e + mask_l * _prolong_shard(setup, ec_pad, idx).reshape(-1)

        for _ in range(setup.nu):
            e = e + om * inv_diag_l * (rm - spmv(e))
        return jnp.where(mask_l > 0, e, r_l)

    return precond


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

def solve_sharded_mg(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    n_shards: Optional[int] = None,
    device_mesh=None,
    dtype=jnp.float32,
    rtol: float = 1e-6,
    maxiter: int = 200,
    nu: Optional[int] = None,
    omega: Optional[float] = None,
    axis: str = "shard",
    coarsest_max_dof: int = 4096,
):
    """Multi-chip MG-preconditioned CG on the full node-dof system.

    Returns (u_full (n_node*ndof,) np.float64, SolveStats, timings dict).
    Per-device fine-level memory is O(N/S); the replicated coarse tail is
    O(N/8).  Dirichlet-only (ForceBC callers use solve_implicit_sharded).

    Smoothing defaults are ndof-aware: Poisson keeps (nu=1, omega=0.8);
    vector problems (elasticity) use (nu=2, omega=0.6) — measured 77 -> 14
    iterations on a 3D elasticity box with damped-Jacobi smoothing.
    """
    if nu is None:
        nu = 1 if ndof == 1 else 2
    if omega is None:
        omega = 0.8 if ndof == 1 else 0.6
    if device_mesh is None:
        devs = jax.devices()
        n_shards = n_shards or len(devs)
        device_mesh = jax.sharding.Mesh(np.array(devs[:n_shards]), (axis,))
    n_shards = device_mesh.devices.size

    t0 = time.perf_counter()
    setup = build_dist_mg_setup(mesh, ndof, dirichlet, element_fn, n_shards,
                                dtype=dtype, nu=nu, omega=omega,
                                coarsest_max_dof=coarsest_max_dof)
    t_setup = time.perf_counter() - t0

    def put(a, spec):
        return jax.device_put(a, NamedSharding(device_mesh, spec))

    coords_sj = put(jnp.asarray(setup.coords_s, dtype=dtype), P(axis))
    validz_sj = put(jnp.asarray(setup.validz_s, dtype=dtype), P(axis))
    bc_j = put(jnp.asarray(setup.bc_mask_pad), P(axis))
    bcv_j = put(jnp.asarray(setup.bc_vals_pad, dtype=dtype), P(axis))
    coarse_arrays, _ = setup.coarse

    def body(coords_b, validz_b, bc_l, bcv_l, ca):
        vals_l, b_l = _assemble_fine_shard(
            setup, element_fn, coords_b[0], validz_b[0], bc_l, bcv_l, axis)
        try:
            d0 = setup.offsets.index(0)
        except ValueError:
            d0 = 0
        diag = vals_l[d0]
        inv_diag = jnp.where(diag != 0, 1.0 / diag, 0.0)
        mask_l = jnp.where(bc_l, 0.0, 1.0).astype(vals_l.dtype)
        spmv_fine = fine_spmv_factory(setup, vals_l, axis)
        precond = dist_gmg_preconditioner(setup, vals_l, inv_diag, mask_l,
                                          ca, axis, spmv=spmv_fine)

        def operator(x_l):
            return spmv_fine(x_l)

        def dot(a, c):
            return jax.lax.psum(
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST), axis)

        def dot2(a, c, d, e):
            pair = jnp.stack([
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST),
                jnp.dot(d, e, precision=jax.lax.Precision.HIGHEST)])
            pair = jax.lax.psum(pair, axis)
            return pair[0], pair[1]

        x0 = bcv_l.astype(vals_l.dtype)                # BC rows solved exactly
        x_l, stats = cg_solve(operator, b_l, x0=x0, precond=precond,
                              rtol=rtol, maxiter=maxiter, dot=dot, dot2=dot2)
        return jax.lax.all_gather(x_l, axis, tiled=True), stats

    mapped = jax.shard_map(
        body,
        mesh=device_mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    t1 = time.perf_counter()
    x, stats = jax.jit(mapped)(coords_sj, validz_sj, bc_j, bcv_j,
                               coarse_arrays)
    x = jax.block_until_ready(x)
    t_solve = time.perf_counter() - t1

    n_true = setup.nnz_true * setup.plane_dofs
    u_full = np.asarray(x, dtype=np.float64)[:n_true]
    timings = dict(setup_s=t_setup, solve_s=t_solve,
                   planes_per_shard=setup.planes_per_shard,
                   distributed_mg=True)
    return u_full, jax.tree.map(np.asarray, stats), timings
