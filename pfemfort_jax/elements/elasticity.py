"""Batched linear-elasticity element kernels (jnp) — element-minor layout.

A batched redesign of the reference's elasticity element subroutines
(/root/reference/src/elementutilitieselasticity2D.F,
 /root/reference/src/elementutilitieselasticity3D.F): fused tensor
contractions over all elements with the element axis LAST (see geometry.py's
layout rule).

Reference conventions honored (quirks and all, documented here):
  * Implicit 2D tria uses the PLANE-STRESS D with D33 = E(1-nu)/(1-nu^2)
    (elasticity2D.F:61-66); explicit 2D kernels use PLANE STRAIN
    (elasticity2D.F:202-206).  Note the reference's D33 has no 1/2 factor
    while its B-matrix rows carry engineering shear — we reproduce that
    exactly in `dmat_plane_stress`.
  * Explicit residual kernels compute stress from TENSORIAL shear strain
    (0.5*(du_c/dx_d + du_d/dx_c); elasticity2D.F:254-257,
    elasticity3D.F:127-133) — reproduced in `elasticity_residual`.
  * Body force enters the implicit RHS as dvol*N*bforce (no density;
    elasticity2D.F:146-149) but the explicit residual as dens*dvol*N*bforce
    (elasticity2D.F:268-271) — callers pick via the `dens` argument.
  * Lumped mass is the row-sum of the consistent mass
    (elasticity2D.F:353-360).  The reference's tetra stiffness/mass declare
    nGP=8 but define only point 1 (elasticity3D.F:272,305,416,429 — reads of
    uninitialized rule data); we use the intended correct 1-pt rule.

DOF layout per element: node-major, component-fast — (i, c) -> i*ndof + c,
matching the reference's TI=(ii-1)*ndof+c (elasticity2D.F:127-133).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from pfemfort_jax.elements.basis import tabulate_basis
from pfemfort_jax.elements.geometry import grads_and_det

# ---------------------------------------------------------------------------
# Constitutive matrices
# ---------------------------------------------------------------------------


def dmat_plane_stress(E: float, nu: float) -> np.ndarray:
    """Plane-stress D exactly as the reference implicit tria kernel builds it
    (elasticity2D.F:61-66), including D33 = b1*(1-nu) (no 1/2)."""
    b1 = E / (1.0 - nu * nu)
    return np.array([
        [b1, b1 * nu, 0.0],
        [b1 * nu, b1, 0.0],
        [0.0, 0.0, b1 * (1.0 - nu)],
    ])


def dmat_plane_strain(E: float, nu: float) -> np.ndarray:
    """Plane-strain D (elasticity2D.F:203-206)."""
    b1 = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return np.array([
        [b1 * (1 - nu), b1 * nu, 0.0],
        [b1 * nu, b1 * (1 - nu), 0.0],
        [0.0, 0.0, b1 * (1 - 2 * nu) * 0.5],
    ])


def dmat_3d(E: float, nu: float) -> np.ndarray:
    """Isotropic 3D D, Voigt order (xx, yy, zz, xy, yz, zx)
    (elasticity3D.F:62-71)."""
    b1 = E / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = b1 * (1.0 - 2.0 * nu) / 2.0
    D = np.zeros((6, 6))
    D[:3, :3] = b1 * nu
    np.fill_diagonal(D[:3, :3], b1 * (1.0 - nu))
    D[3, 3] = D[4, 4] = D[5, 5] = mu
    return D


def _bsel(ndim: int) -> np.ndarray:
    """T[s,c,d]: engineering B-matrix selector, B[s,(j,c)] = T[s,c,d] dN_j/dx_d.

    Voigt rows: 2D (xx, yy, xy); 3D (xx, yy, zz, xy, yz, zx) — matching the
    reference B layout (elasticity2D.F:126-133, elasticity3D.F:359-371).
    """
    if ndim == 2:
        T = np.zeros((3, 2, 2))
        T[0, 0, 0] = 1.0
        T[1, 1, 1] = 1.0
        T[2, 0, 1] = 1.0
        T[2, 1, 0] = 1.0
        return T
    T = np.zeros((6, 3, 3))
    T[0, 0, 0] = 1.0
    T[1, 1, 1] = 1.0
    T[2, 2, 2] = 1.0
    T[3, 0, 1] = 1.0
    T[3, 1, 0] = 1.0
    T[4, 1, 2] = 1.0
    T[4, 2, 1] = 1.0
    T[5, 0, 2] = 1.0
    T[5, 2, 0] = 1.0
    return T


def _ssel(ndim: int) -> np.ndarray:
    """S[s,c,d]: strain selector with TENSORIAL shear (0.5 factors), the form
    the reference's residual kernels use for stress evaluation."""
    S = _bsel(ndim).copy()
    nd = 2 if ndim == 2 else 3
    S[nd:] *= 0.5
    return S


def _b_entries(ndim: int, npe: int):
    """For each Voigt row s and flat dof n=(i*ndim+c): the single (d, i, w)
    such that B[s,n] = w * dN_i/dx_d, or None (structural zero).

    Exploits that the engineering B selector has at most one nonzero
    derivative per (s, c) pair, so B is built from gradN slices with NO
    contraction at all (einsum here would lower to a padded dot_general)."""
    T = _bsel(ndim)
    S = T.shape[0]
    rows = []
    for s in range(S):
        ents = []
        for i in range(npe):
            for c in range(ndim):
                nz = np.nonzero(T[s, c])[0]
                if len(nz) == 0:
                    ents.append(None)
                else:
                    d = int(nz[0])
                    ents.append((d, i, float(T[s, c, d])))
        rows.append(ents)
    return rows


def _build_B(gradN: jnp.ndarray, ndim: int, npe: int) -> jnp.ndarray:
    """B (G, S, ns, E) assembled from gradN slices (pure stacking)."""
    zero = jnp.zeros_like(gradN[:, 0, 0, :])  # (G, E)
    rows = []
    for ents in _b_entries(ndim, npe):
        cols = [zero if e is None else
                (gradN[:, e[0], e[1], :] if e[2] == 1.0
                 else e[2] * gradN[:, e[0], e[1], :])
                for e in ents]
        rows.append(jnp.stack(cols, axis=1))   # (G, ns, E)
    return jnp.stack(rows, axis=1)             # (G, S, ns, E)


def _apply_D(D: np.ndarray, X: jnp.ndarray) -> jnp.ndarray:
    """(D @ X) over the Voigt axis 1 of X (G, S, ..., E) with static numpy D
    scalars — unrolled, skipping structural zeros."""
    S = D.shape[0]
    outs = []
    for s in range(S):
        acc = None
        for t in range(S):
            if D[s, t] == 0.0:
                continue
            term = float(D[s, t]) * X[:, t]
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else jnp.zeros_like(X[:, 0]))
    return jnp.stack(outs, axis=1)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


def elasticity_stiffness(
    coords_em: jnp.ndarray,
    etype: str,
    D: np.ndarray,
    thickness: float = 1.0,
    bforce: Optional[Sequence[float]] = None,
    ngp: Optional[int] = None,
):
    """K = sum_g dvol B^T D B and body-force vector F = sum_g dvol N b.

    coords_em: (npe, ndim, E).  Returns K (ns, ns, E), F (ns, E) with
    ns = npe*ndim.
    """
    dtype = coords_em.dtype
    _, wts, N, dNdu = tabulate_basis(etype, ngp)
    G = dNdu.shape[0]
    ndim = dNdu.shape[1]
    npe = dNdu.shape[2]
    ns = npe * ndim
    Dnp = np.asarray(D, dtype=np.float64)
    S = Dnp.shape[0]
    wts = jnp.asarray(wts, dtype=dtype)
    Nnp = np.asarray(N, dtype=np.float64)

    gradN, det = grads_and_det(coords_em, dNdu)   # (G,d,i,E), (G,E)
    dvol = wts[:, None] * det * thickness         # (G, E)

    B = _build_B(gradN, ndim, npe)                # (G,S,ns,E)
    DB = _apply_D(Dnp, B)
    # K[n,m,e] = sum_{g,s} dvol[g,e] B[g,s,n,e] DB[g,s,m,e] — unrolled
    K = sum(
        (dvol[g][None, None, :] * B[g, s][:, None, :]) * DB[g, s][None, :, :]
        for g in range(G) for s in range(S)
    )

    E_ = coords_em.shape[2]
    if bforce is None:
        F = jnp.zeros((ns, E_), dtype=dtype)
    else:
        bnp = np.asarray(bforce, dtype=np.float64)
        # w_i(e) = sum_g dvol[g,e] N[g,i];  F[(i,c)] = w_i * b_c
        F = jnp.stack([
            float(bnp[c]) * sum(float(Nnp[g, i]) * dvol[g] for g in range(G))
            for i in range(npe) for c in range(ndim)
        ])
    return K, F


def elasticity_residual(
    coords_em: jnp.ndarray,
    disp_em: jnp.ndarray,
    etype: str,
    D: np.ndarray,
    dens: float,
    bforce: jnp.ndarray,
    thickness: float = 1.0,
    ngp: Optional[int] = None,
) -> jnp.ndarray:
    """Explicit-dynamics residual F = dens*dvol*N*b - B^T sigma for all elems.

    disp_em: (ns, E) element nodal displacements, node-major dof-fast.
    bforce: (ndim,) traced array (time-dependent pulse in the drivers).
    Stress uses tensorial shear strain, exactly like the reference residual
    kernels (elasticity2D.F:254-271, elasticity3D.F:127-150).
    Returns F (ns, E).
    """
    dtype = coords_em.dtype
    _, wts, N, dNdu = tabulate_basis(etype, ngp)
    G = dNdu.shape[0]
    ndim = dNdu.shape[1]
    npe = dNdu.shape[2]
    ns = npe * ndim
    E_ = coords_em.shape[2]
    Snp = _ssel(ndim)
    Dnp = np.asarray(D, dtype=np.float64)
    nS = Dnp.shape[0]
    wts = jnp.asarray(wts, dtype=dtype)
    Nnp = np.asarray(N, dtype=np.float64)

    gradN, det = grads_and_det(coords_em, dNdu)
    dvol = wts[:, None] * det * thickness  # (G, E)

    # grad_disp[g,c,d,e] = sum_i disp[(i,c),e] dN_i/dx_d — unrolled over i
    disp3 = disp_em.reshape(npe, ndim, E_)
    gd = sum(disp3[i][None, :, None, :] * gradN[:, None, :, i, :]
             for i in range(npe))           # (G, c, d, E)
    # tensorial strain + stress with static selector/constitutive scalars
    strain = jnp.stack([
        sum(float(Snp[s, c, d]) * gd[:, c, d, :]
            for c in range(ndim) for d in range(ndim)
            if Snp[s, c, d] != 0.0)
        for s in range(nS)
    ], axis=1)                              # (G, S, E)
    stress = _apply_D(Dnp, strain)

    B = _build_B(gradN, ndim, npe)
    Fint = sum(
        dvol[g][None, :] * B[g, s] * stress[g, s][None, :]
        for g in range(G) for s in range(nS)
    )
    b = jnp.asarray(bforce, dtype=dtype)
    # Fbody[(i,c)] = dens * (sum_g dvol N_i) * b_c   (b is traced)
    wnode = [sum(float(Nnp[g, i]) * dvol[g] for g in range(G))
             for i in range(npe)]
    Fbody = dens * jnp.stack([wnode[i] * b[c]
                              for i in range(npe) for c in range(ndim)])
    return Fbody - Fint


def lumped_mass(
    coords_em: jnp.ndarray,
    etype: str,
    dens: float,
    ndof: int,
    ngp: Optional[int] = None,
) -> jnp.ndarray:
    """Row-sum lumped mass vector per element, (npe*ndof, E).

    M[(i,c)] = sum_g dens * w_g |J|_g * N_i * (sum_j N_j), replicated over
    dofs — the row-sum of the reference's block-diagonal consistent mass
    (elasticity2D.F:334-360).
    """
    dtype = coords_em.dtype
    _, wts, N, dNdu = tabulate_basis(etype, ngp)
    G = dNdu.shape[0]
    npe = dNdu.shape[2]
    wts = jnp.asarray(wts, dtype=dtype)
    Nnp = np.asarray(N, dtype=np.float64)
    _, det = grads_and_det(coords_em, dNdu)
    dvol = wts[:, None] * det * dens  # (G, E)
    rowsum = Nnp.sum(axis=1)  # (G,) == 1 for partition-of-unity bases
    Mnode = jnp.stack([
        sum(float(Nnp[g, i] * rowsum[g]) * dvol[g] for g in range(G))
        for i in range(npe)
    ])  # (npe, E)
    return jnp.repeat(Mnode, ndof, axis=0)


def quad_hg_residual(
    coords_em: jnp.ndarray,
    disp_em: jnp.ndarray,
    velo_em: jnp.ndarray,
    E: float,
    nu: float,
    dens: float,
    bforce: jnp.ndarray,
    thickness: float = 0.025,
    hg_visc: float = 1.0,
    wave_speed: float = 50.0,
) -> jnp.ndarray:
    """1-point quad residual with viscous hourglass control.

    Re-implements ResidualElasticityLinearQuadHG
    (/root/reference/src/elementutilitieselasticity2D.F:700-889): closed-form
    midpoint B-matrix, PLANE-STRESS stress from tensorial shear strain, and
    the viscous hourglass force H = -0.25*hg_visc*dens*c*sqrt(A) * (Gamma.v)
    with Gamma = [+1,-1,+1,-1] and the hard-coded wave-speed override
    m_WAVES = 50.0 (elasticity2D.F:869) and thick = 0.025 (:734).

    coords_em (4, 2, E); disp_em/velo_em (8, E).  Returns (8, E).
    """
    dtype = coords_em.dtype
    x = coords_em[:, 0, :]   # (4, E)
    y = coords_em[:, 1, :]
    area = 0.5 * ((x[2] - x[0]) * (y[3] - y[1])
                  + (x[1] - x[3]) * (y[2] - y[0]))
    fact = 2.0 * area
    dNdx = jnp.stack([
        (y[1] - y[3]) / fact,
        (y[2] - y[0]) / fact,
        -(y[1] - y[3]) / fact,
        -(y[2] - y[0]) / fact,
    ])  # (4, E)
    dNdy = jnp.stack([
        (x[3] - x[1]) / fact,
        (x[0] - x[2]) / fact,
        -(x[3] - x[1]) / fact,
        -(x[0] - x[2]) / fact,
    ])

    d3 = disp_em.reshape(4, 2, -1)
    ux, uy = d3[:, 0, :], d3[:, 1, :]   # (4, E)
    g11 = jnp.sum(ux * dNdx, axis=0)
    g12 = jnp.sum(ux * dNdy, axis=0)
    g21 = jnp.sum(uy * dNdx, axis=0)
    g22 = jnp.sum(uy * dNdy, axis=0)
    strain = jnp.stack([g11, g22, 0.5 * (g12 + g21)])  # (3, E)
    Dnp = dmat_plane_stress(E, nu)
    stress = jnp.stack([
        sum(float(Dnp[s, t]) * strain[t] for t in range(3)
            if Dnp[s, t] != 0.0)
        for s in range(3)
    ])

    dvol = area * thickness
    Nmid = 0.25
    b = jnp.asarray(bforce, dtype=dtype)
    Fx = (dens * dvol * Nmid)[None, :] * b[0] \
        - dvol[None, :] * (dNdx * stress[0][None, :]
                           + dNdy * stress[2][None, :])
    Fy = (dens * dvol * Nmid)[None, :] * b[1] \
        - dvol[None, :] * (dNdx * stress[2][None, :]
                           + dNdy * stress[1][None, :])

    # Hourglass viscous force
    hg = 0.25 * hg_visc * dens * wave_speed * jnp.sqrt(jnp.abs(area))
    v3 = velo_em.reshape(4, 2, -1)
    vx, vy = v3[:, 0, :], v3[:, 1, :]
    gamma = jnp.asarray([1.0, -1.0, 1.0, -1.0], dtype=dtype)
    H1 = -(vx[0] - vx[1] + vx[2] - vx[3]) * hg
    H2 = -(vy[0] - vy[1] + vy[2] - vy[3]) * hg
    Fx = Fx + gamma[:, None] * H1[None, :]
    Fy = Fy + gamma[:, None] * H2[None, :]

    return jnp.stack([Fx, Fy], axis=1).reshape(8, -1)
