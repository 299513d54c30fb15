"""Sparse matrix containers (pytrees) for device SpMV.

The workhorse format is padded ELL: every row stores exactly K column/value
slots (K = max row degree, rounded up for lane alignment).  FEM meshes have
tightly bounded node degree (~7 in 2D, ~15 for the 6-tet split), so padding
waste is small and every SpMV becomes a dense (N, K) gather-multiply-reduce —
one fused device loop — instead of the reference's PETSc MPIAIJ CSR
(/root/reference/src/solverpetsc.F:152-166).

Column padding uses the sentinel `n_cols` (one past the end); SpMV feeds a
zero-extended x so padded slots contribute exactly 0.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELLMatrix:
    """Padded ELL sparse matrix. cols (N, K) int32, vals (N, K) dtype.

    `n_cols` is static metadata (pytree aux), so the structure survives jit
    boundaries without its shape parameters becoming traced arrays.
    """

    cols: jax.Array  # (n_rows, K) int32; padded entries == n_cols
    vals: jax.Array  # (n_rows, K)
    n_cols: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_rows(self) -> int:
        return self.cols.shape[0]

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    def _replace(self, **kw) -> "ELLMatrix":
        return dataclasses.replace(self, **kw)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m
