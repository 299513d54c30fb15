"""Mixed-precision iterative refinement: f32 CG inner, f64 residual outer.

The reference runs fully in double precision and targets 1e-8 relative
residuals (solverpetsc.F / PETSc defaults).  The strategy here (SURVEY §7
'Hard parts') keeps the iterations in f32:
  * inner solves in f32 (half the bytes of f64 per SpMV),
  * outer residual r = b - A x in f64 (once per outer cycle),
  * accumulate the solution in f64.
Classical iterative refinement converges to f64-level residuals as long as
CG contracts the error by more than the f32 rounding floor each cycle.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from functools import lru_cache

from pfemfort_jax.solve.cg import SolveStats, cg_solve, jacobi_preconditioner


class RefineStats(NamedTuple):
    outer_iters: int
    total_inner_iters: int
    relres: float          # final f64 relative residual
    converged: bool


def cg_with_refinement(
    op64: Callable,       # x(f64) -> A x in f64
    op32: Callable,       # x(f32) -> A x in f32
    b64: jnp.ndarray,
    precond32: Optional[Callable] = None,
    rtol: float = 1e-8,
    inner_rtol: float = 1e-5,
    max_outer: int = 20,
    inner_maxiter: int = 10_000,
    x0: Optional[jnp.ndarray] = None,
):
    """Solve A x = b to f64 relative residual `rtol` with f32 inner CG.

    `x0`: optional f64 initial guess (the full-system BC-carrying start);
    inner corrections then live on the zero-BC subspace."""
    b64 = b64.astype(jnp.float64)
    bnorm = float(jnp.linalg.norm(b64))
    if bnorm == 0.0:
        return jnp.zeros_like(b64), RefineStats(0, 0, 0.0, True)

    inner = jax.jit(lambda r32: cg_solve(
        op32, r32, precond=precond32, rtol=inner_rtol,
        maxiter=inner_maxiter))
    resid = jax.jit(lambda x64: b64 - op64(x64))

    if x0 is None:
        x64 = jnp.zeros_like(b64)
        r64 = b64
    else:
        x64 = x0.astype(jnp.float64)
        r64 = resid(x64)
    total_inner = 0
    relres = 1.0
    for outer in range(max_outer):
        relres = float(jnp.linalg.norm(r64)) / bnorm
        if relres <= rtol:
            return x64, RefineStats(outer, total_inner, relres, True)
        # scale the residual so the f32 inner solve sees O(1) magnitudes
        scale = float(jnp.max(jnp.abs(r64)))
        scale = scale if scale > 0 else 1.0
        d32, st = inner((r64 / scale).astype(jnp.float32))
        total_inner += int(np.asarray(st.iters))
        x64 = x64 + scale * d32.astype(jnp.float64)
        r64 = resid(x64)
    relres = float(jnp.linalg.norm(r64)) / bnorm
    return x64, RefineStats(max_outer, total_inner, relres, relres <= rtol)


def cg_with_refinement_df(
    offsets,
    vals64: np.ndarray,        # (D, n) float64 DIA values (host)
    b64: np.ndarray,           # (n,) float64 (host)
    precond32: Optional[Callable] = None,
    op32: Optional[Callable] = None,
    rtol: float = 1e-8,
    inner_rtol: float = 1e-5,
    max_outer: int = 20,
    inner_maxiter: int = 10_000,
):
    """Iterative refinement with a DOUBLE-FLOAT (f32x2) outer residual.

    An f32-only form of the f64 outer loop: A and x live
    as (hi, lo) f32 pairs and the outer residual r = b - A x runs through
    compensated TwoSum/TwoProd FMAs (solve/doublefloat.py) — ~2 f32 SpMVs of
    traffic, while tracking the true f64 residual to ~1e-14.  Inner solves
    are plain f32 CG.

    Returns (x (n,) float64 on host, RefineStats).
    """
    from pfemfort_jax.solve.doublefloat import (
        DF, df_add, df_from_f64, df_mul_f32, df_norm2_f32, df_to_f64,
        spmv_dia_df)

    # accept pre-split device-resident DF pairs (saves the host->device
    # transfer on repeated solves)
    vals_df = vals64 if isinstance(vals64, DF) else df_from_f64(
        np.asarray(vals64, dtype=np.float64))
    if isinstance(b64, DF):
        b_df = b64
        bnorm = float(df_norm2_f32(b_df))
    else:
        b_df = df_from_f64(np.asarray(b64, dtype=np.float64))
        bnorm = float(np.linalg.norm(np.asarray(b64, dtype=np.float64)))
    if bnorm == 0.0:
        return np.zeros_like(np.asarray(b64)), RefineStats(0, 0, 0.0, True)
    offsets = tuple(int(o) for o in offsets)
    n = int(b_df.hi.shape[0])

    # Big arrays (vals hi/lo, b hi/lo) are explicit jit ARGUMENTS of cached
    # jits, never closure captures: captured device arrays embed as HLO
    # constants in every compiled program.
    if op32 is None:
        inner, resid_df, update = _df_jits(offsets, n, inner_rtol,
                                           inner_maxiter)
    else:
        inner_c = jax.jit(lambda r32: cg_solve(
            op32, r32, precond=precond32, rtol=inner_rtol,
            maxiter=inner_maxiter))
        inner = lambda vhi, r_hi, scale: inner_c(r_hi / scale)
        _, resid_df, update = _df_jits(offsets, n, inner_rtol,
                                       inner_maxiter)

    z = jnp.zeros_like(b_df.hi)
    x_hi, x_lo = z, z
    r_hi, r_lo = b_df.hi, b_df.lo
    rnorm = bnorm
    total_inner = 0
    for outer in range(max_outer):
        relres = float(rnorm) / bnorm
        if relres <= rtol:
            return _df_to_host(x_hi, x_lo), RefineStats(
                outer, total_inner, relres, True)
        scale = float(jnp.max(jnp.abs(r_hi)))
        scale = scale if scale > 0 else 1.0
        d32, st = inner(vals_df.hi, r_hi, jnp.float32(scale))
        total_inner += int(np.asarray(st.iters))
        x_hi, x_lo = update(x_hi, x_lo, d32, jnp.float32(scale))
        r_hi, r_lo, rnorm = resid_df(vals_df.hi, vals_df.lo,
                                     b_df.hi, b_df.lo, x_hi, x_lo)
    relres = float(rnorm) / bnorm
    return _df_to_host(x_hi, x_lo), RefineStats(
        max_outer, total_inner, relres, relres <= rtol)


def _df_to_host(x_hi, x_lo):
    from pfemfort_jax.solve.doublefloat import DF, df_to_f64
    return df_to_f64(DF(x_hi, x_lo))


@lru_cache(maxsize=32)
def _df_jits(offsets, n, inner_rtol, inner_maxiter):
    """Cached array-argument jits for the double-float refinement: one trace
    per system shape, zero captured arrays."""
    from pfemfort_jax.solve.doublefloat import (
        DF, df_add, df_mul_f32, df_norm2_f32, spmv_dia_df)
    from pfemfort_jax.sparse.dia import DIAMatrix
    from pfemfort_jax.sparse.ops import operator_and_diag

    @jax.jit
    def inner(vals_hi, r_hi, scale):
        A32 = DIAMatrix(vals=vals_hi, offsets=offsets, n_rows=n)
        op, diag = operator_and_diag(A32)
        return cg_solve(op, r_hi / scale,
                        precond=jacobi_preconditioner(diag),
                        rtol=inner_rtol, maxiter=inner_maxiter)

    @jax.jit
    def resid_df(vhi, vlo, bhi, blo, x_hi, x_lo):
        ax = spmv_dia_df(offsets, DF(vhi, vlo), DF(x_hi, x_lo))
        r = df_add(DF(bhi, blo), DF(-ax.hi, -ax.lo))
        return r.hi, r.lo, df_norm2_f32(r)

    @jax.jit
    def update(x_hi, x_lo, d32, scale):
        x = df_add(DF(x_hi, x_lo),
                   df_mul_f32(DF(d32, jnp.zeros_like(d32)), scale))
        return x.hi, x.lo

    return inner, resid_df, update
