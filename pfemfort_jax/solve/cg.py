"""Krylov solvers: preconditioned CG and BiCGStab (pure JAX).

Reimplements the reference's PETSc KSP layer (KSP=CG, PC=BJACOBI by default;
/root/reference/src/solverpetsc.F:187-209, KSPSolve at :476, convergence
report at :479-488) as `lax.while_loop` iterations over a user-supplied
operator.  The operator and dot product are injectable so the same solver
body runs single-chip (jnp.dot) and multi-chip (shard_map + psum over the
device mesh), as PETSc runs the same KSP over MPI.

Convergence: relative residual ||r|| / ||b|| <= rtol, plus divergence
detection (the reference prints "Fails to converge"; solverpetsc.F:481-482).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class SolveStats(NamedTuple):
    iters: jax.Array      # int32, iterations performed
    relres: jax.Array     # final relative residual
    converged: jax.Array  # bool


def _default_dot(a, b):
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)


def cg_solve(
    operator: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    precond: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 10_000,
    dot: Callable = _default_dot,
    dot2: Callable = None,
):
    """Preconditioned conjugate gradients.

    Args:
      operator: x -> A x (SPD).
      b: right-hand side.
      precond: r -> M^{-1} r (default: identity).
      dot: inner product (psum-wrapped inside shard_map for multi-chip).
      dot2: optional fused pair-reduction ((a,b),(c,d)) -> (a.b, c.d); lets
        distributed callers collapse the two per-iteration reductions after
        the preconditioner into ONE psum (latency matters on large meshes).
    Returns (x, SolveStats).
    """
    if dot2 is None:
        dot2 = lambda a, b, c, d: (dot(a, b), dot(c, d))
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    bnorm = jnp.sqrt(dot(b, b))
    tol2 = jnp.maximum(rtol * bnorm, atol) ** 2

    r0 = b - operator(x0)
    z0 = precond(r0)
    rz0 = dot(r0, z0)
    rr0 = dot(r0, r0)

    def cond(state):
        x, r, z, p, rz, rr, k = state
        return jnp.logical_and(rr > tol2, k < maxiter)

    def body(state):
        x, r, z, p, rz, rr, k = state
        Ap = operator(p)
        pAp = dot(p, Ap)
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new, rr = dot2(r, z, r, r)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, rr, k + 1)

    state = (x0, r0, z0, z0, rz0, rr0, jnp.int32(0))
    x, r, z, p, rz, rr, k = jax.lax.while_loop(cond, body, state)
    relres = jnp.sqrt(rr) / jnp.where(bnorm > 0, bnorm, 1.0)
    return x, SolveStats(iters=k, relres=relres, converged=rr <= tol2)


def bicgstab_solve(
    operator: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    precond: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: int = 10_000,
    dot: Callable = _default_dot,
):
    """Preconditioned BiCGStab (for the nonsymmetric systems the reference
    lets users request via the PETSc options file; solverpetsc.F:1-8)."""
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)

    bnorm = jnp.sqrt(dot(b, b))
    tol2 = jnp.maximum(rtol * bnorm, atol) ** 2

    r0 = b - operator(x0)
    rhat = r0

    def cond(state):
        x, r, p, v, rho, alpha, omega, rr, k = state
        return jnp.logical_and(rr > tol2, k < maxiter)

    def body(state):
        x, r, p, v, rho, alpha, omega, rr, k = state
        rho_new = dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = operator(phat)
        alpha = rho_new / dot(rhat, v)
        s = r - alpha * v
        shat = precond(s)
        t = operator(shat)
        omega = dot(t, s) / dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, dot(r, r), k + 1)

    one = jnp.ones((), dtype=b.dtype)
    state = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b),
             one, one, one, dot(r0, r0), jnp.int32(0))
    x, r, p, v, rho, alpha, omega, rr, k = jax.lax.while_loop(
        cond, body, state)
    relres = jnp.sqrt(rr) / jnp.where(bnorm > 0, bnorm, 1.0)
    return x, SolveStats(iters=k, relres=relres, converged=rr <= tol2)


def jacobi_preconditioner(diag: jnp.ndarray) -> Callable:
    """PC=JACOBI: z = r / diag(A) (the elementwise default; the reference
    default BJACOBI+ILU has no efficient dataflow analog — block-Jacobi with
    per-shard blocks lives in parallel/shard_cg.py)."""
    inv = jnp.where(diag != 0, 1.0 / diag, 1.0)
    return lambda r: r * inv
