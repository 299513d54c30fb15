"""Matrix-free CG: assembly-free operator application.

y = A x computed per CG iteration as gather -> batched element apply ->
scatter, never materializing the global matrix.  Trades FLOPs for memory:
the only persistent state is the precomputed element geometry (gradN, dvol)
— the right mode when the assembled matrix would not fit HBM (the 48M-elem
class of problems on few chips).  Structure mirrors the reference's
"recompute K_e every solve" drivers, minus the MatSetValues.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.dofs.dofmap import DofMap
from pfemfort_jax.elements.basis import tabulate_basis
from pfemfort_jax.elements.geometry import grads_and_det
from pfemfort_jax.elements.poisson import poisson_matfree_apply


def make_poisson_matfree_operator(
    coords_em: jnp.ndarray,
    etype: str,
    dofmap: DofMap,
    kappa=None,
    af: float = 1.0,
    ngp: Optional[int] = None,
) -> Tuple[Callable, jnp.ndarray]:
    """Build (operator, diag) for the reduced Poisson system, matrix-free.

    The reduced<->element mapping uses elem_dof with the -1 sentinel routed
    to a zero-padded slot, exactly like the assembled path's scatter plans.
    """
    dtype = coords_em.dtype
    _, wts, N, dNdu = tabulate_basis(etype, ngp)
    ndim = dNdu.shape[1]
    npe = dNdu.shape[2]
    if kappa is None:
        kappa = np.ones(ndim)
    kappa_j = jnp.asarray(np.asarray(kappa, np.float64), dtype=dtype)
    wts_j = jnp.asarray(wts, dtype=dtype)

    gradN, det = grads_and_det(coords_em, dNdu)   # persistent geometry
    dvol = wts_j[:, None] * det

    n = dofmap.total_dof
    ed_t = dofmap.elem_dof.T.astype(np.int64)     # (npe, E), -1 sentinel
    gather_idx = jnp.asarray(np.where(ed_t < 0, n, ed_t).astype(np.int32))
    scatter_idx = gather_idx.reshape(-1)

    def operator(x):
        xp = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
        u_e = xp[gather_idx]                       # (npe, E)
        y_e = poisson_matfree_apply(u_e, gradN, dvol, kappa_j, af=af)
        return jax.ops.segment_sum(y_e.reshape(-1), scatter_idx,
                                   num_segments=n + 1)[:-1]

    # diag(A) restricted to free dofs: sum_e dvol kappa_d gradN_di^2
    G, pdim = dNdu.shape[0], dNdu.shape[1]
    diag_e = sum(dvol[g] * kappa_j[d] * gradN[g, d] * gradN[g, d]
                 for g in range(G) for d in range(pdim)) * af  # (npe, E)
    diag = jax.ops.segment_sum(diag_e.reshape(-1), scatter_idx,
                               num_segments=n + 1)[:-1]
    return operator, diag
