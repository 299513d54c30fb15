"""Mixed-precision iterative refinement tests (f32 inner, f64 outer)."""

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.assembly.assemble import (
    assemble_matrix,
    assemble_rhs,
    dirichlet_rhs_correction,
)
from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.elements.poisson import poisson_element_matrices
from pfemfort_jax.mesh import generate
from pfemfort_jax.solve.cg import jacobi_preconditioner
from pfemfort_jax.solve.refine import cg_with_refinement
from pfemfort_jax.sparse.dia import dia_diagonal, spmv_dia


def _system(dtype):
    mesh, dbc = generate.box_tet(0, 1, 6, 0, 1, 6, 0, 1, 6)
    dofmap = build_dofmap(mesh, 1, dbc)
    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof)
    from pfemfort_jax.elements.geometry import to_element_minor
    coords_e = jnp.asarray(to_element_minor(mesh.elem_coords()),
                           dtype=dtype)
    Ke, Fe = poisson_element_matrices(coords_e, "tetra4", source=-6.0)
    Ad = assemble_matrix(Ke, pattern)
    ubc = jnp.asarray(dofmap.bc_values_full[dofmap.elem_nodedof].T,
                      dtype=dtype)
    b = assemble_rhs(Fe + dirichlet_rhs_correction(Ke, ubc), pattern)
    return mesh, dofmap, Ad, b


def test_refinement_reaches_1e10():
    mesh, dofmap, Ad64, b64 = _system(jnp.float64)
    _, _, Ad32, _ = _system(jnp.float32)

    x, stats = cg_with_refinement(
        op64=lambda v: spmv_dia(Ad64, v),
        op32=lambda v: spmv_dia(Ad32, v),
        b64=b64,
        precond32=jacobi_preconditioner(dia_diagonal(Ad32)),
        rtol=1e-10,
        inner_rtol=1e-5,
    )
    assert stats.converged, stats
    assert stats.relres <= 1e-10
    # true f64 residual check
    r = np.asarray(b64 - spmv_dia(Ad64, x))
    assert np.linalg.norm(r) / np.linalg.norm(np.asarray(b64)) <= 1e-10
    # and the solution is the manufactured one
    u_full = dofmap.expand_solution(np.asarray(x))
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(u_full - u_exact).max() < 1e-7


def test_plain_f32_cg_cannot_reach_1e10():
    """Sanity: without refinement, f32 CG stalls well above 1e-10 —
    demonstrating the refinement is doing real work."""
    from pfemfort_jax.solve.cg import cg_solve

    _, _, Ad32, _ = _system(jnp.float32)
    mesh, dofmap, Ad64, b64 = _system(jnp.float64)
    b32 = b64.astype(jnp.float32)
    x32, st = cg_solve(lambda v: spmv_dia(Ad32, v), b32,
                       precond=jacobi_preconditioner(dia_diagonal(Ad32)),
                       rtol=1e-10, maxiter=2000)
    r = np.asarray(b64 - spmv_dia(Ad64, x32.astype(jnp.float64)))
    relres = np.linalg.norm(r) / np.linalg.norm(np.asarray(b64))
    assert relres > 1e-10  # f32 floor


def test_doublefloat_primitives_match_f64():
    from pfemfort_jax.solve import doublefloat as dfm
    rng = np.random.default_rng(3)
    a64 = rng.standard_normal(1000) * 10.0**rng.integers(-6, 6, 1000)
    b64 = rng.standard_normal(1000) * 10.0**rng.integers(-6, 6, 1000)
    a = dfm.df_from_f64(a64)
    b = dfm.df_from_f64(b64)
    # representation round-trips to ~2^-48 relative
    assert np.max(np.abs(dfm.df_to_f64(a) - a64) / np.abs(a64)) < 1e-13
    s = dfm.df_to_f64(dfm.df_add(a, b))
    ref = dfm.df_to_f64(a) + dfm.df_to_f64(b)
    denom = np.maximum(np.abs(ref), 1e-30)
    assert np.max(np.abs(s - ref) / denom) < 1e-12
    p = dfm.df_to_f64(dfm.df_mul_f32(a, jnp.asarray(b64, jnp.float32)))
    ref = dfm.df_to_f64(a) * np.asarray(
        jnp.asarray(b64, jnp.float32), np.float64)
    denom = np.maximum(np.abs(ref), 1e-30)
    assert np.max(np.abs(p - ref) / denom) < 1e-12


def test_doublefloat_spmv_matches_f64():
    from pfemfort_jax.solve import doublefloat as dfm
    _, _, Ad64, b64 = _system(jnp.float64)
    rng = np.random.default_rng(5)
    x64 = rng.standard_normal(Ad64.n_rows)
    y64 = np.asarray(spmv_dia(Ad64, jnp.asarray(x64)))
    y_df = dfm.df_to_f64(dfm.spmv_dia_df(
        Ad64.offsets,
        dfm.df_from_f64(np.asarray(Ad64.vals)),
        dfm.df_from_f64(x64)))
    scale = np.abs(y64).max()
    assert np.abs(y_df - y64).max() / scale < 1e-12


def test_doublefloat_refinement_reaches_1e10():
    from pfemfort_jax.solve.refine import cg_with_refinement_df
    mesh, dofmap, Ad64, b64 = _system(jnp.float64)
    vals64 = np.asarray(Ad64.vals)
    b64h = np.asarray(b64)
    A32_diag = jnp.asarray(np.asarray(dia_diagonal(Ad64)), jnp.float32)

    x, stats = cg_with_refinement_df(
        Ad64.offsets, vals64, b64h,
        precond32=jacobi_preconditioner(A32_diag),
        rtol=1e-10, inner_rtol=1e-5)
    assert stats.converged, stats
    # TRUE f64 residual via numpy
    n = len(b64h)
    r = b64h.copy()
    for d, o in enumerate(Ad64.offsets):
        lo, hi = max(0, -o), min(n, n - o)
        r[lo:hi] -= vals64[d, lo:hi] * x[lo + o:hi + o]
    assert np.linalg.norm(r) / np.linalg.norm(b64h) <= 1e-9
    u_full = dofmap.expand_solution(x)
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(u_full - u_exact).max() < 1e-7
