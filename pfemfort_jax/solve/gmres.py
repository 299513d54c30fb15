"""Restarted GMRES(m) in pure JAX (lax loops, static restart length).

Completes the Krylov menu the reference exposes through its PETSc options
file (CG <-> BiCGStab <-> GMRES switchable without recompiling;
/root/reference/src/solverpetsc.F:1-8, 198).  Arnoldi with modified
Gram-Schmidt and Givens rotations; the injectable `dot` makes it shard_map-
ready like solve/cg.py.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from pfemfort_jax.solve.cg import SolveStats, _default_dot


def gmres_solve(
    operator: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    precond: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 30,
    maxiter: int = 1000,
    dot: Callable = _default_dot,
):
    """Left-preconditioned restarted GMRES.  Returns (x, SolveStats).

    Convergence is tested on the PRECONDITIONED residual ||M^{-1}(b-Ax)||
    (the Givens-recurrence estimate |g_j|, free per step) relative to
    ||M^{-1}b|| — PETSc's default left-preconditioned convention
    (KSP_NORM_PRECONDITIONED), unlike cg_solve's true-residual test.
    Arnoldi stops MID-CYCLE as soon as |g_j| <= tol, so a converged solve
    does not pay for the rest of its restart window."""
    if precond is None:
        precond = lambda r: r
    if x0 is None:
        x0 = jnp.zeros_like(b)
    m = restart
    n = b.shape[0]
    dtype = b.dtype

    Mb = precond(b)
    bnorm = jnp.sqrt(dot(Mb, Mb))
    tol = jnp.maximum(rtol * bnorm, atol)

    def arnoldi_cycle(x):
        r = precond(b - operator(x))
        beta = jnp.sqrt(dot(r, r))

        V = jnp.zeros((m + 1, n), dtype=dtype)
        H = jnp.zeros((m + 1, m), dtype=dtype)
        cs = jnp.zeros((m,), dtype=dtype)
        sn = jnp.zeros((m,), dtype=dtype)
        g = jnp.zeros((m + 1,), dtype=dtype).at[0].set(beta)
        V = V.at[0].set(r / jnp.where(beta > 0, beta, 1.0))

        def body(carry):
            V, H, cs, sn, g, j = carry
            w = precond(operator(V[j]))

            # modified Gram-Schmidt against all m+1 rows (rows > j are zero)
            def mgs(i, wh):
                w, hcol = wh
                hij = jnp.where(i <= j, dot(w, V[i]), 0.0)
                w = w - hij * V[i]
                return (w, hcol.at[i].set(hij))

            w, hcol = jax.lax.fori_loop(
                0, m + 1, mgs, (w, jnp.zeros((m + 1,), dtype=dtype)))
            hjp1 = jnp.sqrt(dot(w, w))
            hcol = hcol.at[j + 1].set(hjp1)
            V = V.at[j + 1].set(w / jnp.where(hjp1 > 0, hjp1, 1.0))

            # apply previous Givens rotations to the new column
            def rot(i, hc):
                hi = cs[i] * hc[i] + sn[i] * hc[i + 1]
                hip = -sn[i] * hc[i] + cs[i] * hc[i + 1]
                return hc.at[i].set(jnp.where(i < j, hi, hc[i])).at[
                    i + 1].set(jnp.where(i < j, hip, hc[i + 1]))

            hcol = jax.lax.fori_loop(0, m, rot, hcol)

            # new rotation annihilating hcol[j+1]
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c = jnp.where(denom > 0, hcol[j] / denom, 1.0)
            s = jnp.where(denom > 0, hcol[j + 1] / denom, 0.0)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            g = g.at[j + 1].set(-s * g[j]).at[j].set(c * g[j])

            H = H.at[:, j].set(hcol[: m + 1])
            return (V, H, cs, sn, g, j + 1)

        def cond(carry):
            V, H, cs, sn, g, j = carry
            # |g[j]| is the preconditioned residual after j Arnoldi steps:
            # stop the cycle early once converged (each further step costs
            # an operator application)
            return jnp.logical_and(j < m, jnp.abs(g[j]) > tol)

        V, H, cs, sn, g, jdone = jax.lax.while_loop(
            cond, body, (V, H, cs, sn, g, jnp.int32(0)))

        # back-substitute H y = g (upper triangular m x m)
        def back(idx, y):
            j = m - 1 - idx
            hj = H[j]
            s = g[j] - jnp.dot(hj, y, precision=jax.lax.Precision.HIGHEST)
            yj = jnp.where(H[j, j] != 0, s / H[j, j], 0.0)
            return y.at[j].set(yj)

        # unfilled columns (j >= jdone) have H[j,j] == 0 -> y[j] == 0, so
        # the full-m back-substitution is exact for the partial cycle too
        y = jax.lax.fori_loop(0, m, back, jnp.zeros((m,), dtype=dtype))
        x = x + jnp.einsum("i,in->n", y, V[:m],
                           precision=jax.lax.Precision.HIGHEST)
        res = jnp.abs(g[jdone])
        return x, res, jdone

    def cond(state):
        x, res, it = state
        return jnp.logical_and(res > tol, it < maxiter)

    def body(state):
        x, _, it = state
        x, res, jdone = arnoldi_cycle(x)
        return (x, res, it + jdone)

    r0 = precond(b - operator(x0))
    state = (x0, jnp.sqrt(dot(r0, r0)), jnp.int32(0))
    x, res, iters = jax.lax.while_loop(cond, body, state)
    relres = res / jnp.where(bnorm > 0, bnorm, 1.0)
    return x, SolveStats(iters=iters, relres=relres, converged=res <= tol)
