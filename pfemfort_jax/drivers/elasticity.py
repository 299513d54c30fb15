"""Implicit linear-elasticity drivers: the counterparts of
triaelasticityparallelimpl1 (2D, plane stress) and
tetraelasticityparallelimpl1 (3D)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pfemfort_jax.drivers.common import ImplicitResult, solve_implicit
from pfemfort_jax.elements.elasticity import (
    dmat_3d,
    dmat_plane_strain,
    dmat_plane_stress,
    elasticity_stiffness,
)
from pfemfort_jax.mesh.core import Mesh


def solve_elasticity(
    mesh: Mesh,
    dirichlet: np.ndarray,
    E: float,
    nu: float,
    force_bc: Optional[np.ndarray] = None,
    bforce: Optional[Sequence[float]] = None,
    thickness: float = 1.0,
    plane: str = "stress",
    dtype=None,
    rtol: float = 1e-8,
    maxiter: Optional[int] = None,
    method: str = "cg",
    refine: bool = False,
    bc_mode: str = "reduced",
    precond: str = "jacobi",
) -> ImplicitResult:
    """Static linear elasticity K u = F with Dirichlet + nodal Force BCs.

    The reference's implicit 2D path is plane STRESS
    (/root/reference/src/elementutilitieselasticity2D.F:61-66) — that is the
    default here; pass plane='strain' for the explicit-dynamics constitutive
    law.  3D uses the standard isotropic D
    (/root/reference/src/elementutilitieselasticity3D.F:287-296).
    """
    ndim = mesh.ndim
    if ndim == 2:
        D = dmat_plane_stress(E, nu) if plane == "stress" \
            else dmat_plane_strain(E, nu)
    else:
        D = dmat_3d(E, nu)

    def element_fn(coords_e):
        return elasticity_stiffness(
            coords_e, mesh.etype, D,
            thickness=thickness if ndim == 2 else 1.0,
            bforce=bforce)

    if bc_mode == "full":
        from pfemfort_jax.drivers.common import solve_implicit_fullsystem
        return solve_implicit_fullsystem(
            mesh, ndim, dirichlet, element_fn, force_bc=force_bc,
            dtype=dtype, rtol=rtol, maxiter=maxiter, method=method,
            precond=precond)
    return solve_implicit(
        mesh, ndim, dirichlet, element_fn, force_bc=force_bc,
        dtype=dtype, rtol=rtol, maxiter=maxiter, method=method,
        refine=refine)
