"""Full-system 1e-8 double-precision solve at arbitrary scale: exact-f64
host stencil assembly + multigrid-preconditioned f32 inner CG + double-float
outer refinement.

This is the composition that matches the reference's flagship run
(48M tets solved fully in f64 by PETSc CG across 40 MPI ranks,
/root/reference/README.md:19-21, solverpetsc.F:476-490) on ONE chip:

  * the exact f64 system comes from the constant-stencil host assembly
    (assembly/stencil64.py) — seconds, no device f64;
  * the operator lives on device as a double-float (hi, lo) f32 pair;
  * inner solves run full-speed f32 CG preconditioned by geometric multigrid
    whose FINE level is the (host-symmetrized) hi part — no 48M-element
    re-assembly for the hierarchy (solve/multigrid.py `fine_matrix=`);
  * the outer loop computes the TRUE (double-float ~ f64) residual with
    compensated FMAs (solve/doublefloat.py) and accumulates x in (hi, lo).

Iteration economics: ~3 outer cycles x ~10 MG-CG inner iterations instead
of the O(n) Jacobi-CG count (546 at n=200).
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.assembly.stencil64 import (
    lattice_bc_f64,
    stencil_full_system_f64,
    zero_rows_f64,
)
from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.solve.cg import cg_solve
from pfemfort_jax.solve.doublefloat import DF, df_from_f64, df_to_f64
from pfemfort_jax.solve.multigrid import GMGMeta, build_gmg, gmg_preconditioner
from pfemfort_jax.solve.refine import RefineStats, _df_jits
from pfemfort_jax.sparse.dia import DIAMatrix


@lru_cache(maxsize=16)
def _mg_inner_jit(offsets: Tuple[int, ...], n: int, lattice,
                  meta: GMGMeta, inner_rtol: float, inner_maxiter: int):
    """Cached jit for the MG-preconditioned f32 inner solve.  All big arrays
    (operator values, hierarchy) are ARGUMENTS, not captures — captured
    device arrays embed as HLO constants (see solve/refine.py:_df_jits)."""
    from pfemfort_jax.sparse.ops import operator_and_diag

    @jax.jit
    def inner(vals_hi, arrays, r_hi, scale):
        A32 = DIAMatrix(vals=vals_hi, offsets=offsets, n_rows=n,
                        lattice=lattice)
        op, _ = operator_and_diag(A32)
        pre = gmg_preconditioner(arrays, meta)
        return cg_solve(op, r_hi / scale, precond=pre,
                        rtol=inner_rtol, maxiter=inner_maxiter)

    return inner


def solve_box_poisson_1e8(
    mesh: Mesh,
    dirichlet: np.ndarray,
    rtol: float = 1e-8,
    inner_rtol: float = 1e-4,
    inner_maxiter: int = 100,
    max_outer: int = 20,
    nu: int = 1,
    omega: float = 0.8,
    source: float = -6.0,
    coarsest_max_dof: int = 4096,
):
    """Solve the box-tet Poisson problem to a TRUE <=rtol f64 relative
    residual of the exact f64 system.

    Returns (u_full (n_node,) f64, RefineStats, timings dict).
    """
    timings = {}
    st = mesh.structure
    lattice = (st["nez"] + 1, st["ney"] + 1, st["nex"] + 1)

    from pfemfort_jax.solve.multigrid import _is_affine_box

    t0 = time.perf_counter()
    bc_mask, bc_vals = lattice_bc_f64(mesh, dirichlet)
    use_device_stencil = _is_affine_box(mesh) is not None
    if use_device_stencil:
        # DF system built ON DEVICE (assembly/stencil64.py): no host f64
        # build (~30 s at 48M) and no ~1 GB (hi, lo) upload
        from pfemfort_jax.assembly.stencil64 import (
            stencil_full_system_df_device)

        offsets, (vh, vl), (rh, rl) = stencil_full_system_df_device(
            mesh, source=source)
        n = vh.shape[1]
        bcf_b = jnp.asarray(bc_mask)
        bch = jnp.asarray(bc_vals.astype(np.float32))
        bcl = jnp.asarray(
            (bc_vals - bc_vals.astype(np.float32).astype(np.float64)
             ).astype(np.float32))

        @jax.jit
        def _apply_bc(vh, vl, rh, rl, bcf_b, bch, bcl):
            outs_h, outs_l = [], []
            for d, o in enumerate(offsets):
                tgt = jnp.float32(1.0 if o == 0 else 0.0)
                outs_h.append(jnp.where(bcf_b, tgt, vh[d]))
                outs_l.append(jnp.where(bcf_b, jnp.float32(0.0), vl[d]))
            return (jnp.stack(outs_h), jnp.stack(outs_l),
                    jnp.where(bcf_b, bch, rh), jnp.where(bcf_b, bcl, rl))

        vh, vl, rh, rl = _apply_bc(vh, vl, rh, rl, bcf_b, bch, bcl)
        vals_df = DF(vh, vl)
        b_df = DF(rh, rl)
        jax.block_until_ready(rh)
        timings["host_assemble_s"] = time.perf_counter() - t0
        rhs64 = None
    else:
        offsets, vals64, rhs64 = stencil_full_system_f64(mesh,
                                                         source=source)
        zero_rows_f64(offsets, vals64, rhs64, bc_mask, bc_vals)
        n = vals64.shape[1]
        timings["host_assemble_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if not use_device_stencil:
        vals_df = df_from_f64(vals64)
        b_df = df_from_f64(rhs64)
    # symmetrized fine level computed ON DEVICE from the already-uploaded
    # hi plane (the host symmetrized_f32 copy would be a third ~D*N*4-byte
    # upload, ~470 MB at the 48M problem); semantics
    # identical to assembly/stencil64.py:symmetrized_f32
    w_off = max(max(offsets), -min(offsets), 0)

    @jax.jit
    def _sym_dev(vals_hi, bcf):
        ext = jnp.pad(bcf, (w_off, w_off), constant_values=0.0)
        outs = []
        for d, o in enumerate(offsets):
            col_bc = jax.lax.slice_in_dim(ext, w_off + o, w_off + o + n)
            if o == 0:
                v = jnp.where(bcf > 0, 1.0, vals_hi[d])
            else:
                v = jnp.where((bcf > 0) | (col_bc > 0), 0.0, vals_hi[d])
            outs.append(v)
        return jnp.stack(outs)

    bcf_dev = jnp.asarray(bc_mask, dtype=jnp.float32)
    A_sym = DIAMatrix(vals=_sym_dev(vals_df.hi, bcf_dev),
                      offsets=offsets, n_rows=n, lattice=lattice)
    element_fn = None  # fine level is pre-assembled; coarse tail re-derives
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    element_fn = lambda c: poisson_element_matrices(
        c, "tetra4", source=source)
    mg = build_gmg(mesh, 1, bc_mask, element_fn, dtype=jnp.float32,
                   nu=nu, omega=omega, coarsest_max_dof=coarsest_max_dof,
                   fine_matrix=A_sym)
    if mg is None:
        raise ValueError("mesh does not support the geometric hierarchy")
    arrays, meta = mg
    jax.block_until_ready(arrays.coarse_inv)
    timings["mg_setup_s"] = time.perf_counter() - t0

    inner = _mg_inner_jit(offsets, n, lattice, meta,
                          inner_rtol, inner_maxiter)
    _, resid_df, update = _df_jits(offsets, n, inner_rtol, inner_maxiter)

    if rhs64 is not None:
        bnorm = float(np.linalg.norm(rhs64))
    else:
        # hi-plane f32 norm: 1e-7 relative, used only to normalize relres
        bnorm = float(jnp.linalg.norm(b_df.hi))
    if bnorm == 0.0:
        return np.zeros(n), RefineStats(0, 0, 0.0, True), timings

    t0 = time.perf_counter()
    x0 = np.where(bc_mask, bc_vals, 0.0)
    x_df = df_from_f64(x0)
    x_hi, x_lo = x_df.hi, x_df.lo
    r_hi, r_lo, rnorm = resid_df(vals_df.hi, vals_df.lo,
                                 b_df.hi, b_df.lo, x_hi, x_lo)
    total_inner = 0
    relres = float(rnorm) / bnorm
    outer = 0
    while outer < max_outer and relres > rtol:
        scale = float(jnp.max(jnp.abs(r_hi)))
        scale = scale if scale > 0 else 1.0
        d32, stats = inner(vals_df.hi, arrays, r_hi, jnp.float32(scale))
        total_inner += int(np.asarray(stats.iters))
        x_hi, x_lo = update(x_hi, x_lo, d32, jnp.float32(scale))
        r_hi, r_lo, rnorm = resid_df(vals_df.hi, vals_df.lo,
                                     b_df.hi, b_df.lo, x_hi, x_lo)
        relres = float(rnorm) / bnorm
        outer += 1
    timings["solve_s"] = time.perf_counter() - t0

    u = df_to_f64(DF(x_hi, x_lo))
    return u, RefineStats(outer, total_inner, relres, relres <= rtol), \
        timings
