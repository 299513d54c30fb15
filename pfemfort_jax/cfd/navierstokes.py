"""Incompressible Navier-Stokes: explicit fractional-step (Chorin) solver,
dimension-generic (2D tria3/tria6/quad4 and 3D tetra4/hexa8/prism6).

The reference ships only abandoned scaffolding for this capability
(cfdexplicittria6node.F calls a nonexistent residual and its update is
commented out; elementutilitiescfd.F does not compile and contains BOTH a
tria and a tetra kernel intent — /root/reference/src/elementutilitiescfd.F:23,
417; SURVEY §2.2).  This module provides a WORKING equal-order fractional-step
scheme in any dimension, built from the same ingredients the reference
intended (lumped velocity mass, nodal momentum residual, pressure Poisson
solve):

  1. u* = u^n + dt M_L^{-1} R(u^n)        momentum: convection + viscosity
  2. L p = -(1/dt) ∫ N div u*             pressure Poisson (our DIA/ELL CG)
  3. u^{n+1} = u* - dt M_L^{-1} G p       projection

All element operations are batched element-minor kernels unrolled over the
(static) spatial dimension; the pressure solve reuses the assembled Poisson
operator (static geometry => assembled once).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.assembly.assemble import assemble_matrix
from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.elements.basis import tabulate_basis
from pfemfort_jax.elements.geometry import grads_and_det, to_element_minor
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.solve.cg import cg_solve, jacobi_preconditioner
from pfemfort_jax.sparse.ops import operator_and_diag


class NSResult(NamedTuple):
    velocity: np.ndarray     # (n_node, ndim)
    pressure: np.ndarray     # (n_node,)
    div_history: np.ndarray  # (nsteps,) max |div u| after each projection
    times: np.ndarray


def fractional_step_ns(
    mesh: Mesh,
    velocity_bc: np.ndarray,   # (n, 3) [node, dof(0..ndim-1), value]
    nu_visc: float,
    dt: float,
    nsteps: int,
    pressure_pin: Optional[int] = None,
    u0: Optional[np.ndarray] = None,
    rtol_p: float = 1e-8,
    sample_every: int = 10,
    dtype=None,
) -> NSResult:
    """Run the fractional-step scheme on any supported mesh (2D or 3D).

    velocity_bc fixes velocity components (e.g. lid-driven cavity/cube
    walls).  pressure_pin: node whose pressure is fixed to 0 (default: 0).
    """
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    n = mesh.n_node
    nd = mesh.ndim
    if pressure_pin is None:
        pressure_pin = 0

    # --- static tables -----------------------------------------------------
    _, wts, N, dNdu = tabulate_basis(mesh.etype, 1)
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()),
                            dtype=dtype)
    gradN, det = grads_and_det(coords_em, dNdu)   # (G, nd, npe, E), (G, E)
    wts_j = jnp.asarray(wts, dtype=dtype)
    dvol = wts_j[:, None] * det                   # (G, E)

    conn_t = jnp.asarray(mesh.conn.T.astype(np.int32))   # (npe, E)
    npe = mesh.npe
    G = dNdu.shape[0]
    Njd = jnp.asarray(np.asarray(N, dtype=np.float64), dtype=dtype)

    # lumped velocity mass (per node, density 1)
    Mn_e = jnp.stack([sum(Njd[g, i] * dvol[g] for g in range(G))
                      for i in range(npe)])              # (npe, E)
    M = jax.ops.segment_sum(Mn_e.reshape(-1), conn_t.reshape(-1),
                            num_segments=n)
    Minv = jnp.where(M > 0, 1.0 / M, 1.0)

    # pressure Poisson operator: Dirichlet pin at one node
    pin_bc = np.array([[pressure_pin, 0, 0.0]])
    dof_p = build_dofmap(mesh, 1, pin_bc)
    pat_p = build_pattern(dof_p.elem_dof, dof_p.total_dof)
    Kp, _ = poisson_element_matrices(coords_em, mesh.etype)
    Ap = assemble_matrix(Kp, pat_p)
    op_p, diag_p = operator_and_diag(Ap)
    scatter_p = jnp.asarray(dof_p.assy_for_soln)  # reduced row -> node

    # velocity BC masks
    vbc_mask = np.zeros((nd, n), dtype=bool)
    vbc_val = np.zeros((nd, n))
    if velocity_bc is not None and len(velocity_bc):
        nn = velocity_bc[:, 0].astype(np.int64)
        dd = velocity_bc[:, 1].astype(np.int64)
        vbc_mask[dd, nn] = True
        vbc_val[dd, nn] = velocity_bc[:, 2]
    vbc_mask = jnp.asarray(vbc_mask)
    vbc_val = jnp.asarray(vbc_val, dtype=dtype)

    def scatter(Fe):
        """(npe, E) element vector -> (n,) nodal sum."""
        return jax.ops.segment_sum(Fe.reshape(-1), conn_t.reshape(-1),
                                   num_segments=n)

    def gp_value(comp_em):
        """Nodal values (npe, E) -> gauss-point values (G, E)."""
        return sum(Njd[:, i][:, None] * comp_em[i][None, :]
                   for i in range(npe))

    def gp_grad(comp_em, a):
        """d(comp)/dx_a at gauss points, (G, E)."""
        return sum(gradN[:, a, i, :] * comp_em[i][None, :]
                   for i in range(npe))

    def apply_vbc(U):
        return jnp.where(vbc_mask, vbc_val, U)

    def momentum_residual(U_em):
        """R_i^c = -int N_i (u . grad)u_c - nu int gradN_i . grad u_c.

        U_em: (nd, npe, E) nodal velocities; returns (nd, npe, E)."""
        Ug = [gp_value(U_em[c]) for c in range(nd)]             # (G, E)
        dU = [[gp_grad(U_em[c], a) for a in range(nd)]
              for c in range(nd)]                               # [c][a]
        conv = [sum(Ug[a] * dU[c][a] for a in range(nd))
                for c in range(nd)]
        out = []
        for c in range(nd):
            rows = []
            for i in range(npe):
                r = sum(dvol[g] * (-Njd[g, i] * conv[c][g]
                                   - nu_visc * sum(
                                       gradN[g, a, i, :] * dU[c][a][g]
                                       for a in range(nd)))
                        for g in range(G))
                rows.append(r)
            out.append(jnp.stack(rows))
        return jnp.stack(out)

    def nodal_div_rhs(U):
        """b_i = int N_i div(u) (n,), plus gauss-point divergence (G, E)."""
        U_em = U[:, conn_t]                                     # (nd,npe,E)
        div_g = sum(gp_grad(U_em[c], c) for c in range(nd))
        Fe = jnp.stack([sum(dvol[g] * Njd[g, i] * div_g[g]
                            for g in range(G)) for i in range(npe)])
        return scatter(Fe), div_g

    def pressure_gradient(p):
        """nodal weak gradient: (G p)_i^a = int N_i dp/dx_a -> (nd, n)."""
        p_em = p[conn_t]
        out = []
        for a in range(nd):
            dpda = gp_grad(p_em, a)
            Fa = jnp.stack([sum(dvol[g] * Njd[g, i] * dpda[g]
                                for g in range(G)) for i in range(npe)])
            out.append(scatter(Fa))
        return jnp.stack(out)

    @jax.jit
    def step(carry, _):
        U, p = carry
        # 1. explicit momentum
        U_em = U[:, conn_t]
        R_e = momentum_residual(U_em)
        Us = U + dt * Minv[None, :] * jnp.stack(
            [scatter(R_e[c]) for c in range(nd)])
        Us = apply_vbc(Us)
        # 2. pressure Poisson.  Note the sign: the discrete div-of-gradient
        # D M^-1 G approximates -L (integration by parts flips the sign),
        # so removing the divergence requires  L p = -(1/dt) int N div u*.
        bdiv, _ = nodal_div_rhs(Us)
        b_red = (-bdiv / dt)[scatter_p]
        p_red, _ = cg_solve(op_p, b_red,
                            x0=p[scatter_p],
                            precond=jacobi_preconditioner(diag_p),
                            rtol=rtol_p, maxiter=2000)
        p_full = jnp.zeros((n,), dtype=Us.dtype).at[scatter_p].set(p_red)
        # 3. projection
        Gp = pressure_gradient(p_full)
        Un = apply_vbc(Us - dt * Minv[None, :] * Gp)
        _, div_g = nodal_div_rhs(Un)
        maxdiv = jnp.max(jnp.abs(div_g))
        return (Un, p_full), maxdiv

    if u0 is None:
        U = jnp.zeros((nd, n), dtype=dtype)
    else:
        U = jnp.asarray(np.asarray(u0).T, dtype=dtype)
    U = apply_vbc(U)
    p = jnp.zeros((n,), dtype=dtype)

    (U, p), divs = jax.lax.scan(step, (U, p), None, length=nsteps)

    return NSResult(
        velocity=np.asarray(U, dtype=np.float64).T,
        pressure=np.asarray(p, dtype=np.float64),
        div_history=np.asarray(divs),
        times=np.arange(nsteps) * dt,
    )
