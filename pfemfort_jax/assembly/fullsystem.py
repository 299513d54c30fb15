"""Full-size DOF system with MatZeroRows-style Dirichlet BCs.

Parity with triapoissonserialimpl3: instead of eliminating BC dofs from the
numbering, the system spans ALL node-dofs and Dirichlet rows are replaced by
identity rows with the applied value on the rhs —
`MatZeroRows(nDBC, rows, 1.0, solnTemp, rhs)`
(/root/reference/src/triapoissonserialimpl3.F:351-359, 557-558).

Like PETSc's MatZeroRows (without ZeroRowsColumns), COLUMNS are not zeroed,
so the operator is mildly nonsymmetric at BC couplings; the reference runs
CG on it anyway and converges because the BC components of the residual are
zero from the first iteration when x0 carries the BC values.  We reproduce
that behavior (and also expose BiCGStab/GMRES for safety).
"""

from __future__ import annotations

from typing import Union

import jax.numpy as jnp
import numpy as np

from pfemfort_jax.sparse.dia import DIAMatrix
from pfemfort_jax.sparse.formats import ELLMatrix


def zero_dirichlet_rows(
    A: Union[DIAMatrix, ELLMatrix],
    b: jnp.ndarray,
    bc_mask: jnp.ndarray,     # (n,) bool, True on Dirichlet rows
    bc_values: jnp.ndarray,   # (n,) applied values (0 on free rows)
):
    """Return (A', b') with BC rows replaced by identity and b'[bc]=value."""
    if isinstance(A, DIAMatrix):
        vals = A.vals
        new_vals = []
        for d, o in enumerate(A.offsets):
            diag_val = 1.0 if o == 0 else 0.0
            new_vals.append(jnp.where(bc_mask, diag_val, vals[d]))
        A2 = A._replace(vals=jnp.stack(new_vals))
    else:
        rows_bc = bc_mask[:, None]
        is_diag = (A.cols == jnp.arange(A.n_rows)[:, None])
        vals = jnp.where(rows_bc, jnp.where(is_diag, 1.0, 0.0), A.vals)
        A2 = A._replace(vals=vals)
    b2 = jnp.where(bc_mask, bc_values, b)
    return A2, b2
