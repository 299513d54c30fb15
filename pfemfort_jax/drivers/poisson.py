"""Poisson drivers: the counterparts of triapoissonserialimpl1/2/3,
triapoissonparallelimpl1/2 and tetrapoissonparallelimpl1."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pfemfort_jax.drivers.common import (
    ImplicitResult,
    solve_implicit,
    solve_implicit_fullsystem,
)
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh.core import Mesh

# The reference drivers hard-code the source term: 0 for the 2D problems
# (elementutilitiespoisson.F:83) and -6 for the 3D manufactured solution
# u = x^2+y^2+z^2 (elementutilitiespoisson.F:172).
_DEFAULT_SOURCE = {"tetra4": -6.0}


def solve_poisson(
    mesh: Mesh,
    dirichlet: np.ndarray,
    kappa: Optional[Sequence[float]] = None,
    source=None,
    af: float = 1.0,
    dtype=None,
    rtol: float = 1e-8,
    maxiter: Optional[int] = None,
    method: str = "cg",
    bc_mode: str = "reduced",
    precond: str = "jacobi",
    refine: bool = False,
    matrix_free: bool = False,
) -> ImplicitResult:
    """Solve -div(kappa grad u) = source with Dirichlet BCs.

    Matches the reference drivers' defaults: kappa = 1 per axis, source 0
    (2D) / -6 (tetra4), CG + (block-)Jacobi to relative tolerance.

    bc_mode: 'reduced' eliminates BC dofs from the system (impl1/impl2
    semantics); 'full' keeps the full-size system with MatZeroRows identity
    rows (impl3 semantics, triapoissonserialimpl3.F:557-558).
    precond: 'jacobi', 'cheby' (Chebyshev polynomial of D^{-1}A — the
    matrix-free ILU-class option for unstructured meshes, reduced mode), or
    'mg' (geometric multigrid; bc_mode='full' on structured lattice meshes
    only — falls back to Jacobi elsewhere).
    refine: mixed-precision f32-inner/f64-outer iterative refinement.
    """
    if source is None:
        source = _DEFAULT_SOURCE.get(mesh.etype, 0.0)

    def element_fn(coords_e):
        return poisson_element_matrices(
            coords_e, mesh.etype, kappa=kappa, af=af, source=source)

    if matrix_free:
        return _solve_poisson_matfree(
            mesh, dirichlet, kappa=kappa, af=af, source=source,
            dtype=dtype, rtol=rtol, maxiter=maxiter)
    if bc_mode == "full":
        return solve_implicit_fullsystem(
            mesh, 1, dirichlet, element_fn,
            dtype=dtype, rtol=rtol, maxiter=maxiter, method=method,
            precond=precond)
    return solve_implicit(
        mesh, 1, dirichlet, element_fn,
        dtype=dtype, rtol=rtol, maxiter=maxiter, method=method,
        refine=refine, precond=precond)


def _solve_poisson_matfree(mesh, dirichlet, kappa, af, source,
                           dtype, rtol, maxiter) -> ImplicitResult:
    """Assembly-free CG: no global matrix is ever materialized."""
    import time

    import jax
    import jax.numpy as jnp

    from pfemfort_jax.dofs.dofmap import build_dofmap
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.solve.cg import cg_solve, jacobi_preconditioner
    from pfemfort_jax.solve.matfree import make_poisson_matfree_operator
    import numpy as np

    if dtype is None:
        dtype = jnp.zeros(0).dtype
    t0 = time.perf_counter()
    dofmap = build_dofmap(mesh, 1, dirichlet)
    t_pattern = time.perf_counter() - t0
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()),
                            dtype=dtype)
    operator, diag = make_poisson_matfree_operator(
        coords_em, mesh.etype, dofmap, kappa=kappa, af=af)

    # rhs: source term + matrix-free Dirichlet elimination
    _, Fe_src = poisson_element_matrices(
        coords_em, mesh.etype, kappa=kappa, af=af, source=source)
    n = dofmap.total_dof
    ed_t = dofmap.elem_dof.T.astype(np.int64)
    scat = jnp.asarray(np.where(ed_t < 0, n, ed_t).astype(np.int32)
                       ).reshape(-1)
    ubc_e = jnp.asarray(dofmap.bc_values_full[dofmap.elem_nodedof].T,
                        dtype=dtype)
    from pfemfort_jax.elements.basis import tabulate_basis
    from pfemfort_jax.elements.geometry import grads_and_det
    from pfemfort_jax.elements.poisson import poisson_matfree_apply
    _, wts, _, dNdu = tabulate_basis(mesh.etype, None)
    gradN, det = grads_and_det(coords_em, dNdu)
    dvol = jnp.asarray(wts, dtype=dtype)[:, None] * det
    kap = jnp.ones((mesh.ndim,), dtype=dtype) if kappa is None \
        else jnp.asarray(np.asarray(kappa, np.float64), dtype=dtype)
    Fe = Fe_src - poisson_matfree_apply(ubc_e, gradN, dvol, kap, af=af)
    b = jax.ops.segment_sum(Fe.reshape(-1), scat, num_segments=n + 1)[:-1]

    if maxiter is None:
        maxiter = max(10 * n, 1000)
    t1 = time.perf_counter()
    u, stats = jax.jit(lambda b: cg_solve(
        operator, b, precond=jacobi_preconditioner(diag),
        rtol=rtol, maxiter=maxiter))(b)
    u = jax.block_until_ready(u)
    t_solve = time.perf_counter() - t1
    u_full = dofmap.expand_solution(np.asarray(u, dtype=np.float64))
    return ImplicitResult(
        u_full=u_full, u_reduced=u,
        stats=jax.tree.map(lambda a: np.asarray(a), stats),
        timings=dict(pattern_s=t_pattern, solve_s=t_solve))
