"""Exact-f64 stencil assembly + MG/double-float refinement to 1e-8
(assembly/stencil64.py + solve/highprec.py) — the flagship 48M path's
correctness harness at test scale."""

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.assembly.stencil64 import (
    lattice_bc_f64,
    stencil_full_system_f64,
    symmetrized_f32,
    zero_rows_f64,
)
from pfemfort_jax.mesh import generate
from pfemfort_jax.solve.highprec import solve_box_poisson_1e8


def test_stencil_f64_matches_elementwise_assembly():
    """Constant-stencil f64 values == device structured assembly from the
    per-element kernels (f64), up to congruent-cell rounding noise."""
    from pfemfort_jax.assembly.structured import (
        assemble_dia_structured, assemble_rhs_structured,
        build_structured_plan)
    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.elements.poisson import poisson_element_matrices

    mesh, _ = generate.box_tet(0, 1, 5, 0, 1, 6, 0, 1, 7)
    offsets, vals, rhs = stencil_full_system_f64(mesh)

    plan = build_structured_plan(5, 6, 7)
    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()))
    Ke, Fe = poisson_element_matrices(coords_em, "tetra4", source=-6.0)
    A = assemble_dia_structured(Ke, plan)
    b = assemble_rhs_structured(Fe, plan)

    assert offsets == A.offsets
    np.testing.assert_allclose(vals, np.asarray(A.vals),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(rhs, np.asarray(b), rtol=1e-12, atol=1e-13)


def test_zero_rows_and_symmetrize():
    mesh, dbc = generate.box_tet(0, 1, 4, 0, 1, 4, 0, 1, 4)
    offsets, vals, rhs = stencil_full_system_f64(mesh)
    bc_mask, bc_vals = lattice_bc_f64(mesh, dbc)
    zero_rows_f64(offsets, vals, rhs, bc_mask, bc_vals)
    d0 = offsets.index(0)
    assert (vals[d0][bc_mask] == 1.0).all()
    assert (rhs[bc_mask] == bc_vals[bc_mask]).all()

    sym = symmetrized_f32(offsets, vals, bc_mask)
    # symmetric: A[r, r+o] == A[r+o, r] for every offset pair
    n = vals.shape[1]
    for d, o in enumerate(offsets):
        if o <= 0:
            continue
        dn = offsets.index(-o)
        np.testing.assert_allclose(sym[d, :n - o], sym[dn, o:], atol=0)


def test_solve_1e8_manufactured():
    """True f64 relres <= 1e-8 and exact-to-f64 nodal values for the
    manufactured u = x^2+y^2+z^2 (nodally exact for this FEM)."""
    mesh, dbc = generate.box_tet(0, 1, 16, 0, 1, 16, 0, 1, 16)
    u, stats, timings = solve_box_poisson_1e8(mesh, dbc, rtol=1e-8)
    assert stats.converged, stats
    assert stats.relres <= 1e-8
    assert stats.outer_iters <= 6, stats
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(u - u_exact).max() < 1e-7


def test_solve_1e8_uneven_box():
    mesh, dbc = generate.box_tet(0, 2, 12, 0, 1, 16, 0, 1, 20)
    u, stats, _ = solve_box_poisson_1e8(mesh, dbc, rtol=1e-8)
    assert stats.converged, stats
    u_exact = (mesh.coords ** 2).sum(axis=1)
    assert np.abs(u - u_exact).max() < 1e-6


def test_device_df_stencil_matches_host_f64():
    """The device double-float slice-add build (stencil_full_system_df_
    device) must reproduce the exact host-f64 system to DF accuracy."""
    import numpy as np

    from pfemfort_jax.assembly.stencil64 import (
        stencil_full_system_df_device, stencil_full_system_f64)
    from pfemfort_jax.mesh import generate

    mesh, _ = generate.box_tet(0, 1, 6, 0, 1, 5, 0, 1, 7)
    offs_h, vals64, rhs64 = stencil_full_system_f64(mesh)
    offs_d, (vh, vl), (rh, rl) = stencil_full_system_df_device(mesh)
    assert offs_h == offs_d
    v_dev = np.asarray(vh, np.float64) + np.asarray(vl, np.float64)
    r_dev = np.asarray(rh, np.float64) + np.asarray(rl, np.float64)
    scale = np.abs(vals64).max()
    assert np.abs(v_dev - vals64).max() < 1e-12 * scale
    rscale = max(np.abs(rhs64).max(), 1e-30)
    assert np.abs(r_dev - rhs64).max() < 1e-12 * rscale
