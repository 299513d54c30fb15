"""Distributed CG over a device mesh via shard_map.

The reference's multi-rank solve is PETSc KSP CG over MPI: SpMV halo
exchange + dot-product allreduces (/root/reference/src/solverpetsc.F:476,
SURVEY §2.6).  Here the same CG body (solve/cg.py) runs inside `shard_map`:
  * rows of the padded ELL matrix are sharded over the 'shard' mesh axis,
  * SpMV gathers x with `all_gather` across the devices (the halo forms
    below exchange only the neighbours' rows),
  * dot products are local dots + `psum` — exactly PETSc's VecDot allreduce.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from pfemfort_jax.parallel.halo import (
    halo_width,
    lattice_halo_plan,
    spmv_dia_halo,
    spmv_dia_halo_lattice,
)
from pfemfort_jax.solve.cg import (
    bicgstab_solve,
    cg_solve,
    jacobi_preconditioner,
)


def _krylov_body(method: str):
    """Uniform (operator, b_l, precond, rtol, maxiter, dot, dot2) -> (x_l,
    stats) over the Krylov menu — the distributed analog of the reference's
    options-file -ksp_type switch (/root/reference/src/solverpetsc.F:198):
    every solver in solve/cg.py + solve/gmres.py takes an injectable `dot`,
    so the SAME body runs inside shard_map with psum reductions."""
    if method == "cg":
        return lambda op, b, pc, rtol, maxiter, dot, dot2: cg_solve(
            op, b, precond=pc, rtol=rtol, maxiter=maxiter,
            dot=dot, dot2=dot2)
    if method == "bicgstab":
        return lambda op, b, pc, rtol, maxiter, dot, dot2: bicgstab_solve(
            op, b, precond=pc, rtol=rtol, maxiter=maxiter, dot=dot)
    if method == "gmres":
        from pfemfort_jax.solve.gmres import gmres_solve

        return lambda op, b, pc, rtol, maxiter, dot, dot2: gmres_solve(
            op, b, precond=pc, rtol=rtol, maxiter=maxiter, dot=dot)
    raise ValueError(f"unknown ksp method {method!r}")


def _inv_small_blocks(B: jax.Array) -> jax.Array:
    """Closed-form batched inverse of (m, nd, nd) SPD blocks, nd in {1,2,3}.

    Zero-diagonal rows (padding equations) are replaced by identity
    rows/columns first so the block stays invertible and decoupled."""
    nd = B.shape[-1]
    eye = jnp.eye(nd, dtype=B.dtype)
    for a in range(nd):
        zero = B[:, a, a] == 0
        B = B.at[:, a, :].set(jnp.where(zero[:, None], eye[a], B[:, a, :]))
        B = B.at[:, :, a].set(jnp.where(zero[:, None], eye[a], B[:, :, a]))
    if nd == 1:
        return 1.0 / B
    if nd == 2:
        a, b = B[:, 0, 0], B[:, 0, 1]
        c, d = B[:, 1, 0], B[:, 1, 1]
        det = a * d - b * c
        inv = jnp.stack([jnp.stack([d, -b], -1),
                         jnp.stack([-c, a], -1)], -2)
        return inv / det[:, None, None]
    if nd == 3:
        a, b, c = B[:, 0, 0], B[:, 0, 1], B[:, 0, 2]
        d, e, f = B[:, 1, 0], B[:, 1, 1], B[:, 1, 2]
        g, h, i = B[:, 2, 0], B[:, 2, 1], B[:, 2, 2]
        A_ = e * i - f * h
        B_ = -(d * i - f * g)
        C_ = d * h - e * g
        det = a * A_ + b * B_ + c * C_
        inv = jnp.stack([
            jnp.stack([A_, -(b * i - c * h), b * f - c * e], -1),
            jnp.stack([B_, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([C_, -(a * h - b * g), a * e - b * d], -1),
        ], -2)
        return inv / det[:, None, None]
    return jnp.linalg.inv(B)


def block_jacobi_dia_preconditioner(offsets, vals_l: jax.Array, nd: int):
    """PC=BJACOBI with per-node (nd x nd) blocks, extracted from local DIA
    rows — the reference's default preconditioner (solverpetsc.F:206) at
    node-block granularity.  vals_l: (D, P) shard-local DIA values; rows
    k*nd+a couple to cols k*nd+b via diagonal offset (b - a)."""
    P_ = vals_l.shape[1]
    m = P_ // nd
    oidx = {o: d for d, o in enumerate(offsets)}
    cols = []
    for a in range(nd):
        row = []
        for b in range(nd):
            o = b - a
            if o in oidx:
                row.append(vals_l[oidx[o]].reshape(m, nd)[:, a])
            else:
                row.append(jnp.zeros((m,), dtype=vals_l.dtype))
        cols.append(jnp.stack(row, -1))
    B = jnp.stack(cols, -2)                       # (m, nd, nd)
    Binv = _inv_small_blocks(B)

    def apply(r):
        return jnp.einsum("kab,kb->ka", Binv, r.reshape(m, nd),
                          precision=jax.lax.Precision.HIGHEST).reshape(-1)
    return apply


def block_jacobi_ell_preconditioner(cols_local: jax.Array,
                                    vals_l: jax.Array, nd: int):
    """PC=BJACOBI with per-node (nd x nd) blocks extracted from the shard's
    LOCAL ELL block — the reference's default preconditioner
    (solverpetsc.F:206) on the unstructured distributed path.

    Requires the node-aligned row layout (parallel/shard.py: each node owns
    nd consecutive local rows), so entry (r, c) is in-block iff c is an OWN
    column (< P) in the same nd-aligned group.  Extraction is pure strided
    slicing + masked row reductions (no gathers); padding rows invert to
    identity inside `_inv_small_blocks`.
    """
    P_, K = vals_l.shape
    m = P_ // nd
    rows = jnp.arange(P_, dtype=cols_local.dtype)[:, None]
    inblk = (cols_local < P_) & ((cols_local // nd) == (rows // nd))
    contrib = jnp.where(inblk, vals_l, 0.0)
    cmod = jnp.where(inblk, cols_local % nd, nd)       # nd = dropped
    cols = []
    for a in range(nd):
        c_a = cmod[a::nd]                              # (m, K)
        v_a = contrib[a::nd]
        row = [jnp.sum(jnp.where(c_a == b, v_a, 0.0), axis=1)
               for b in range(nd)]
        cols.append(jnp.stack(row, -1))
    B = jnp.stack(cols, -2)                            # (m, nd, nd)
    Binv = _inv_small_blocks(B)

    def apply(r):
        return jnp.einsum("kab,kb->ka", Binv, r.reshape(m, nd),
                          precision=jax.lax.Precision.HIGHEST).reshape(-1)
    return apply


def distributed_cg_solve(
    device_mesh: JMesh,
    cols: jax.Array,       # (n_rows_padded, K) int32, global column ids
    vals: jax.Array,       # (n_rows_padded, K)
    b: jax.Array,          # (n_rows_padded,)
    rtol: float = 1e-8,
    maxiter: int = 10_000,
    axis: str = "shard",
    method: str = "cg",
):
    """Run Jacobi-preconditioned CG with rows sharded over `axis`.

    Returns (x (n_rows_padded,), SolveStats) with x fully replicated.
    """
    n_rows = cols.shape[0]
    krylov = _krylov_body(method)

    def local_diag(cols_l, vals_l, row0):
        rows = row0 + jnp.arange(cols_l.shape[0], dtype=cols_l.dtype)[:, None]
        return jnp.sum(jnp.where(cols_l == rows, vals_l, 0), axis=1)

    def body(cols_l, vals_l, b_l):
        idx = jax.lax.axis_index(axis)
        rows_local = cols_l.shape[0]
        row0 = (idx * rows_local).astype(cols_l.dtype)

        def operator(x_l):
            x_full = jax.lax.all_gather(x_l, axis, tiled=True)
            xp = jnp.concatenate(
                [x_full, jnp.zeros((1,), dtype=x_full.dtype)])
            return jnp.sum(vals_l * xp[cols_l], axis=1)

        def dot(a, c):
            return jax.lax.psum(
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST), axis)

        def dot2(a, c, d, e):
            # single fused reduction for two inner products
            pair = jnp.stack([
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST),
                jnp.dot(d, e, precision=jax.lax.Precision.HIGHEST)])
            pair = jax.lax.psum(pair, axis)
            return pair[0], pair[1]

        diag = local_diag(cols_l, vals_l, row0)
        x_l, stats = krylov(operator, b_l, jacobi_preconditioner(diag),
                            rtol, maxiter, dot, dot2)
        # replicate the solution (the reference's VecScatterCreateToAll,
        # triapoissonparallelimpl1.F:938-943) so multi-PROCESS callers can
        # read it without cross-host gathers on the host side
        return jax.lax.all_gather(x_l, axis, tiled=True), stats

    mapped = jax.shard_map(
        body,
        mesh=device_mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,  # tiled all_gather IS replicated; checker can't infer
    )
    return jax.jit(mapped)(cols, vals, b)


def distributed_cg_solve_ell(
    device_mesh: JMesh,
    cols_local: jax.Array,   # (n_rows_padded, K) int32 LOCAL ids (per shard)
    vals: jax.Array,         # (n_rows_padded, K)
    b: jax.Array,            # (n_rows_padded,)
    send_rows: jax.Array,    # (S*S, Wx) int32, row-sharded over dim 0
    wx: int,
    rtol: float = 1e-8,
    maxiter: int = 10_000,
    axis: str = "shard",
    ndof_block: int = 1,
    ic0_blocks=None,
    amg=None,
    method: str = "cg",
):
    """Jacobi-CG over the unstructured per-shard ELL with the pairwise
    ghost exchange (parallel/dist_ell.py:spmv_ell_halo): per-iteration comm
    is ONE all_to_all of S*Wx surface values + the psum dots — O(partition
    surface), not the all_gather's O(N).

    `ndof_block` > 1 selects per-node block-Jacobi preconditioning (the
    reference default PC=BJACOBI, solverpetsc.F:206); requires the
    node-aligned shard layout (parallel/shard.py builds it for ndof > 1).

    `ic0_blocks`: stacked (S, ...) per-shard IC(0) factor arrays
    (solve/ic0.py:build_ic0_shard_blocks) — PC=BJACOBI with one ILU-class
    sub-factorization per rank, the reference's ACTUAL parallel default
    (block-Jacobi's default sub-PC is ILU).  Overrides `ndof_block`.

    `amg`: (DistSAMG, metas) from solve/amg.py:build_dist_samg — the
    distributed smoothed-aggregation V-cycle (sharded fine smoothing +
    replicated algebraic tail); mesh-independent iterations on ANY mesh.
    Takes precedence over the other preconditioners."""
    from pfemfort_jax.parallel.dist_ell import spmv_ell_halo

    n_rows = cols_local.shape[0]
    n_shards = device_mesh.devices.size
    P_ = n_rows // n_shards
    krylov = _krylov_body(method)
    ic_arrays = ()
    if ic0_blocks is not None:
        ic_arrays = tuple(jnp.asarray(a, dtype=vals.dtype)
                          if a.dtype == np.float64 else jnp.asarray(a)
                          for a in ic0_blocks)
    amg_sharded = ()
    amg_repl = None
    amg_metas = None
    amg_om0 = None
    if amg is not None:
        dist_amg, amg_metas, tail_dev = amg
        amg_om0 = dist_amg.om0
        amg_sharded = (dist_amg.p0_cols_s,
                       dist_amg.p0_vals_s.astype(vals.dtype))
        amg_repl = tail_dev          # replicated tail (already dtype'd)
    n_ic = len(ic_arrays)

    def body(cols_l, vals_l, send_rows_l, b_l, *rest):
        ic_l = rest[:n_ic]
        amg_l = rest[n_ic:]

        def operator(x_l):
            return spmv_ell_halo(vals_l, cols_l, send_rows_l, x_l, axis)

        def local_diag():
            rows = jnp.arange(P_, dtype=cols_l.dtype)[:, None]
            return jnp.sum(jnp.where(cols_l == rows, vals_l, 0), axis=1)

        def dot(a, c):
            return jax.lax.psum(
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST), axis)

        def dot2(a, c, d, e):
            pair = jnp.stack([
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST),
                jnp.dot(d, e, precision=jax.lax.Precision.HIGHEST)])
            pair = jax.lax.psum(pair, axis)
            return pair[0], pair[1]

        if amg_metas is not None:
            from pfemfort_jax.solve.amg import dist_samg_preconditioner
            pc_l, pv_l = (a[0] for a in amg_l[:2])
            tail_d = amg_l[2]
            d = local_diag()
            inv_d = jnp.where(d != 0, 1.0 / d, 0.0)
            precond = dist_samg_preconditioner(
                pc_l, pv_l, amg_om0, tail_d, amg_metas, inv_d,
                operator, axis)
        elif ic_l:
            from pfemfort_jax.solve.ic0 import ic0_block_apply
            tc_, tv_, ttc_, ttv_, di_ = (a[0] for a in ic_l)
            precond = ic0_block_apply(tc_, tv_, ttc_, ttv_, di_)
        elif ndof_block > 1 and P_ % ndof_block == 0:
            precond = block_jacobi_ell_preconditioner(cols_l, vals_l,
                                                      ndof_block)
        else:
            precond = jacobi_preconditioner(local_diag())
        x_l, stats = krylov(operator, b_l, precond, rtol, maxiter,
                            dot, dot2)
        return jax.lax.all_gather(x_l, axis, tiled=True), stats

    amg_args = amg_sharded + ((amg_repl,) if amg_repl is not None else ())
    amg_specs = tuple(P(axis, *([None] * (a.ndim - 1)))
                      for a in amg_sharded)
    if amg_repl is not None:
        amg_specs = amg_specs + (P(),)      # replicated tail pytree
    mapped = jax.shard_map(
        body,
        mesh=device_mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis))
        + tuple(P(axis, *([None] * (a.ndim - 1))) for a in ic_arrays)
        + amg_specs,
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(mapped)(cols_local, vals, send_rows, b,
                           *ic_arrays, *amg_args)


def distributed_cg_solve_dia(
    device_mesh: JMesh,
    offsets,               # static tuple of diagonal offsets
    dia_vals: jax.Array,   # (D, n_rows_padded)
    b: jax.Array,          # (n_rows_padded,)
    rtol: float = 1e-8,
    maxiter: int = 10_000,
    axis: str = "shard",
    ndof_block: int = 1,
    lattice=None,
    method: str = "cg",
):
    """CG with the halo-exchange DIA SpMV: per-iteration comm is two
    ppermute shifts of the halo width W = max|offset| (plus psum dots)
    instead of an all_gather of the full vector — the overlap-friendly
    'interior SpMV + neighbor halo' structure PETSc uses over MPI
    (SURVEY §5 'long-context' row).

    ndof_block > 1 selects per-node block-Jacobi preconditioning
    (the reference default PC=BJACOBI, solverpetsc.F:206).

    `lattice`: optional static reduced-lattice shape.  When shard rows are
    plane-aligned (parallel/shard.py rounds slab shards to whole planes)
    and the offsets decompose into a stencil, the in-shard SpMV runs as the
    N-D sliced-window form the single-device path uses, instead of 1-D
    shifted slices.
    """
    n_rows = b.shape[0]
    n_shards = device_mesh.devices.size
    rows_per_shard = n_rows // n_shards
    krylov = _krylov_body(method)
    w = halo_width(offsets)
    use_halo = w <= rows_per_shard
    plan = None
    if use_halo and lattice is not None:
        plane = int(np.prod(lattice[1:]))
        if rows_per_shard % plane == 0:
            plan = lattice_halo_plan(offsets, tuple(lattice))
            if plan is not None and plan[1] * plane > rows_per_shard:
                plan = None
    try:
        d0 = list(offsets).index(0)
    except ValueError:
        d0 = None

    def body(vals_l, b_l):
        if plan is not None:
            shifts, wp = plan

            def operator(x_l):
                return spmv_dia_halo_lattice(shifts, vals_l, x_l,
                                             tuple(lattice), wp, axis)
        elif use_halo:
            def operator(x_l):
                return spmv_dia_halo(offsets, vals_l, x_l, w, axis)
        else:
            # halo wider than a shard (tiny shards): gather the whole x and
            # slice at the shard's global row offset
            from pfemfort_jax.sparse.dia import spmv_dia_local

            def operator(x_l):
                x_full = jax.lax.all_gather(x_l, axis, tiled=True)
                row0 = jax.lax.axis_index(axis) * rows_per_shard
                return spmv_dia_local(offsets, vals_l, x_full, row0)

        def dot(a, c):
            return jax.lax.psum(
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST), axis)

        def dot2(a, c, d, e):
            pair = jnp.stack([
                jnp.dot(a, c, precision=jax.lax.Precision.HIGHEST),
                jnp.dot(d, e, precision=jax.lax.Precision.HIGHEST)])
            pair = jax.lax.psum(pair, axis)
            return pair[0], pair[1]

        if ndof_block > 1 and b_l.shape[0] % ndof_block == 0:
            precond = block_jacobi_dia_preconditioner(
                offsets, vals_l, ndof_block)
        else:
            diag = vals_l[d0] if d0 is not None else jnp.zeros_like(b_l)
            precond = jacobi_preconditioner(diag)
        x_l, stats = krylov(operator, b_l, precond, rtol, maxiter,
                            dot, dot2)
        # replicate the solution (VecScatterCreateToAll analog) for
        # multi-process-safe host readback
        return jax.lax.all_gather(x_l, axis, tiled=True), stats

    mapped = jax.shard_map(
        body,
        mesh=device_mesh,
        in_specs=(P(None, axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,  # tiled all_gather IS replicated; checker can't infer
    )
    return jax.jit(mapped)(dia_vals, b)


def shard_arrays(device_mesh: JMesh, axis: str, *arrays):
    """Place arrays with their leading dim sharded over `axis`."""
    out = []
    for a in arrays:
        spec = P(axis, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(device_mesh, spec)))
    return tuple(out)
