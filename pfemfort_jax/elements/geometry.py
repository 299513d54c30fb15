"""Batched isoparametric geometry (device-side, jnp) — ELEMENT-MINOR layout.

The batched replacement for the reference's per-element
computeBasisFunctions2D/3D (/root/reference/src/elementutilitiesbasisfuncs.F:
165-234, 430-538): Jacobians, determinants and physical gradients for ALL
elements at ALL Gauss points in one shot.

Layout rule: the element axis E is LAST, so every elementwise step reads
and writes contiguous runs of elements; the tiny (pdim x pdim) inverses are
closed-form and unrolled.  Whether this beats a batched einsum on the GPU
is not measured.

Index conventions (matching the Fortran):
  J[g,a,d,e] = sum_i dNdu[g,a,i] * coords[i,d,e]     ("B" in the reference)
  gradN[g,d,i,e] = sum_a inv(J)[g,d,a,e] * dNdu[g,a,i]
  det[g,e] = det(J[g,e])                              ("Jac")
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def to_element_minor(coords_e: np.ndarray) -> np.ndarray:
    """(E, npe, ndim) host array -> (npe, ndim, E) contiguous."""
    return np.ascontiguousarray(np.transpose(coords_e, (1, 2, 0)))


def _det_inv_2x2(J):
    # J (G, 2, 2, E)
    a, b = J[:, 0, 0], J[:, 0, 1]
    c, d = J[:, 1, 0], J[:, 1, 1]
    det = a * d - b * c
    inv = jnp.stack([
        jnp.stack([d, -b], axis=1),
        jnp.stack([-c, a], axis=1),
    ], axis=1) / det[:, None, None]
    return det, inv


def _det_inv_3x3(J):
    a = J[:, 0, 0]; b = J[:, 0, 1]; c = J[:, 0, 2]
    d = J[:, 1, 0]; e = J[:, 1, 1]; f = J[:, 1, 2]
    g = J[:, 2, 0]; h = J[:, 2, 1]; i = J[:, 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv = jnp.stack([
        jnp.stack([A, -(b * i - c * h), (b * f - c * e)], axis=1),
        jnp.stack([B, (a * i - c * g), -(a * f - c * d)], axis=1),
        jnp.stack([C, -(a * h - b * g), (a * e - b * d)], axis=1),
    ], axis=1) / det[:, None, None]
    return det, inv


def grads_and_det(coords_em: jnp.ndarray, dNdu):
    """Physical gradients and Jacobian determinants, element-minor.

    Args:
      coords_em: (npe, ndim, E) element nodal coordinates.
      dNdu:      (G, pdim, npe) parametric derivatives (static table).
    Returns:
      gradN: (G, ndim, npe, E)  physical derivatives dN/dx_d,
      det:   (G, E)             Jacobian determinant ("Jac").
    """
    # Contractions over the tiny (npe, pdim) axes are UNROLLED into
    # elementwise multiply-adds instead of einsum, so XLA fuses them and
    # materializes no batch-major (E, k, k) temporaries.
    dN = np.asarray(dNdu, dtype=np.float64)
    G, pdim, npe = dN.shape
    dt_ = coords_em.dtype
    # J[g,a,d,e] = sum_i dNdu[g,a,i] * coords[i,d,e] — unrolled over i
    J = sum(
        jnp.asarray(dN[:, :, i], dtype=dt_)[:, :, None, None]
        * coords_em[i][None, None, :, :]
        for i in range(npe)
    )
    if J.shape[2] == 2:
        det, inv = _det_inv_2x2(J)
    else:
        det, inv = _det_inv_3x3(J)
    # gradN[g,d,i,e] = sum_a inv[g,d,a,e] * dNdu[g,a,i] — unrolled over a
    gradN = sum(
        inv[:, :, a, None, :]
        * jnp.asarray(dN[:, a, :], dtype=dt_)[:, None, :, None]
        for a in range(pdim)
    )
    return gradN, det
