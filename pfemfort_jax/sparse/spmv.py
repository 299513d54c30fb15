"""ELL SpMV (jnp; XLA lowers the column gather to the device's gathers).

y = A x for a padded-ELL matrix: a dense (N, K) gather of x followed by a
multiply and a lane-local K-reduction.  This replaces the reference's PETSc
MatMult inside KSPSolve (/root/reference/src/solverpetsc.F:476).
"""

from __future__ import annotations

import jax.numpy as jnp

from pfemfort_jax.sparse.formats import ELLMatrix


def spmv_ell(A: ELLMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y[i] = sum_k vals[i,k] * x[cols[i,k]], padded cols hit a zero slot."""
    xp = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
    return jnp.sum(A.vals * xp[A.cols], axis=1)


def spmv_ell_local(A: ELLMatrix, x_global: jnp.ndarray) -> jnp.ndarray:
    """SpMV where the row block is a shard but columns index a full vector
    (used inside shard_map after gathering x)."""
    xp = jnp.concatenate([x_global, jnp.zeros((1,), dtype=x_global.dtype)])
    return jnp.sum(A.vals * xp[A.cols], axis=1)


def extract_diagonal(A: ELLMatrix) -> jnp.ndarray:
    """diag(A) from ELL: pick the slot whose column equals the row id."""
    rows = jnp.arange(A.n_rows, dtype=A.cols.dtype)[:, None]
    hit = (A.cols == rows)
    return jnp.sum(jnp.where(hit, A.vals, 0), axis=1)
