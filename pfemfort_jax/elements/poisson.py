"""Batched Poisson element kernels (device-side, jnp) — element-minor layout.

A batched redesign of StiffnessResidualPoissonLinearTria/Tetra
(/root/reference/src/elementutilitiespoisson.F:23-101, 107-193): one fused
tensor contraction over ALL elements (element axis last — see geometry.py's
layout rule) instead of a per-element subroutine.

Math (identical to the reference):
  K[i,j] = af * sum_g w_g |J|_g * sum_d kappa_d dN_i/dx_d dN_j/dx_d
  F[i]   = sum_g w_g |J|_g * N_i * source          (reference "force";
           0 for the 2D kernel, hard-coded -6 for the 3D manufactured
           solution u = x^2+y^2+z^2 — elementutilitiespoisson.F:83,172)
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import jax.numpy as jnp
import numpy as np

from pfemfort_jax.elements.basis import tabulate_basis, DEFAULT_NGP
from pfemfort_jax.elements.geometry import grads_and_det

SourceLike = Union[float, Callable]


def poisson_element_matrices(
    coords_em: jnp.ndarray,
    etype: str,
    kappa: Optional[Sequence[float]] = None,
    af: float = 1.0,
    source: SourceLike = 0.0,
    ngp: Optional[int] = None,
):
    """Element stiffness and source vectors for all elements at once.

    Args:
      coords_em: (npe, ndim, E) device array of element nodal coordinates
                 (element-minor; see geometry.to_element_minor).
      etype:    element type name.
      kappa:    diffusivity per axis (kx, ky[, kz]); default all ones
                (the reference drivers set kx=ky=kz=1).
      af:       generalized-alpha factor multiplying K (reference timeData(2),
                always 1.0 in the drivers).
      source:   constant source, or callable f(xg)->(G,E) evaluated at
                physical Gauss-point coordinates xg (G,ndim,E).
    Returns:
      K (npe, npe, E), F (npe, E)  in coords_em.dtype.
    """
    dtype = coords_em.dtype
    pts, wts, N, dNdu = tabulate_basis(etype, ngp)
    ndim = dNdu.shape[1]
    if kappa is None:
        kappa = np.ones(ndim)
    kappa = jnp.asarray(np.asarray(kappa, dtype=np.float64), dtype=dtype)
    wts = jnp.asarray(wts, dtype=dtype)
    Nj = jnp.asarray(N, dtype=dtype)

    gradN, det = grads_and_det(coords_em, dNdu)   # (G,d,i,E), (G,E)
    dvol = wts[:, None] * det                     # (G, E)
    G, pdim, npe = dNdu.shape

    # K[i,j,e] = af * sum_{g,d} dvol kappa_d gradN[g,d,i,e] gradN[g,d,j,e]
    # Unrolled over the tiny (g, d) axes: dot_general lowering of this
    # einsum materializes (E,npe,npe) batch-major temporaries padded 32x.
    wgrad = gradN * (dvol[:, None, None, :] * kappa[None, :, None, None])
    K = af * sum(
        wgrad[g, d][:, None, :] * gradN[g, d][None, :, :]
        for g in range(G) for d in range(pdim)
    )

    if callable(source):
        xg = sum(Nj[:, i][:, None, None] * coords_em[i][None, :, :]
                 for i in range(npe))  # (G, ndim, E)
        f = source(xg)  # (G, E)
    else:
        f = jnp.asarray(source, dtype=dtype)
        f = jnp.broadcast_to(f, dvol.shape)
    df = dvol * f
    F = sum(df[g][None, :] * Nj[g][:, None] for g in range(G))
    return K, F


def poisson_matfree_apply(
    u_e: jnp.ndarray,
    gradN: jnp.ndarray,
    dvol: jnp.ndarray,
    kappa: jnp.ndarray,
    af: float = 1.0,
) -> jnp.ndarray:
    """Matrix-free K_e @ u_e for all elements (for assembly-free CG).

    u_e (npe, E); gradN (G, d, npe, E); dvol (G, E); returns (npe, E).
    """
    G, pdim, npe, _ = gradN.shape
    du = sum(gradN[:, :, j, :] * u_e[j][None, None, :]
             for j in range(npe))                                # grad u
    flux = du * kappa[None, :, None] * dvol[:, None, :]
    return af * sum(gradN[g, d] * flux[g, d][None, :]
                    for g in range(G) for d in range(pdim))
