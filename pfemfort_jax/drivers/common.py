"""Shared implicit-solve pipeline: dofmap -> pattern -> assemble -> Krylov.

This is the single skeleton every reference driver re-implements inline
(read files -> DOF maps -> preallocate -> assemble -> solve -> gather;
/root/reference/src/triapoissonserialimpl1.F and 14 siblings).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.assembly.assemble import (
    assemble_matrix,
    assemble_rhs,
    dirichlet_rhs_correction,
)
from pfemfort_jax.assembly.pattern import build_pattern
from pfemfort_jax.dofs.dofmap import build_dofmap, reduced_lattice
from pfemfort_jax.elements.geometry import to_element_minor
from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.solve.cg import (
    SolveStats,
    bicgstab_solve,
    cg_solve,
    jacobi_preconditioner,
)
from pfemfort_jax.sparse.ops import operator_and_diag


class ImplicitResult(NamedTuple):
    u_full: np.ndarray        # (n_node*ndof,) solution incl. BC values
    u_reduced: jax.Array      # (total_dof,) device solution
    stats: SolveStats
    timings: dict
    # element partition of a sharded solve (the reference's elem_procid
    # cell field, writervtk.F:169-174); None for single-device solves
    elem_part: Optional[np.ndarray] = None


def build_reduced_assembler(mesh, ndof, dofmap, element_fn, dtype):
    """Return (assemble(coords_em) -> (A, b_reduced), setup_seconds).

    Picks the fastest formulation of the reference's reduced (BC-eliminated)
    system for this mesh:
      * generator-lattice meshes with a rectangular free box: scatter-FREE
        structured slice-add assembly of the FULL system + slice-only
        reduction (assembly/structured.py:reduce_structured_system) — no
        pattern build, no segment sums, pure HBM streaming;
      * everything else: the general precomputed-scatter path
        (assembly/pattern.py + segment sums).
    Both produce the identical reduced system (tests/test_structured.py).
    """
    from pfemfort_jax.dofs.dofmap import full_lattice, reduced_box

    t0 = time.perf_counter()
    kind = (mesh.structure or {}).get("kind")
    red_box = reduced_box(mesh, dofmap) if kind else None
    if red_box is not None:
        from pfemfort_jax.assembly import structured as st

        if kind == "box_tet":
            plan = st.build_structured_plan(
                mesh.structure["nex"], mesh.structure["ney"],
                mesh.structure["nez"], ndof=ndof)
            asm_mat, asm_rhs = (st.assemble_dia_structured,
                                st.assemble_rhs_structured)
        else:
            plan = st.build_structured_plan_2d(
                mesh.structure["nex"], mesh.structure["ney"], ndof=ndof)
            asm_mat, asm_rhs = (st.assemble_dia_structured_2d,
                                st.assemble_rhs_structured_2d)
        shape = full_lattice(mesh)
        bc_vals_full = jnp.asarray(dofmap.bc_values_full, dtype=dtype)

        # Above ~12M elements the one-shot Ke + geometry temps grow past
        # 20 GB at 48M elements — switch to the z-slab-chunked fori_loop
        # assembler.
        n_chunks = 1
        if kind == "box_tet" and mesh.n_elem > 12_000_000:
            nez = mesh.structure["nez"]
            per = mesh.n_elem // nez          # elements per z-layer
            want = -(-mesh.n_elem // 6_000_000)
            for cand in range(want, nez + 1):
                if nez % cand == 0:
                    n_chunks = cand
                    break

        def assemble(coords_em):
            if n_chunks > 1:
                A_full, b_full = st.assemble_structured_chunked(
                    element_fn, coords_em, plan, n_chunks)
            else:
                Ke, Fe_src = element_fn(coords_em)
                A_full = asm_mat(Ke, plan)
                b_full = asm_rhs(Fe_src, plan)
            return st.reduce_structured_system(
                A_full, b_full, red_box, shape, bc_vals_full)

        return assemble, time.perf_counter() - t0

    pattern = build_pattern(dofmap.elem_dof, dofmap.total_dof,
                            lattice=reduced_lattice(mesh, dofmap))
    ubc_e = jnp.asarray(dofmap.bc_values_full[dofmap.elem_nodedof].T,
                        dtype=dtype)

    def assemble(coords_em):
        Ke, Fe_src = element_fn(coords_em)
        A = assemble_matrix(Ke, pattern)
        b = assemble_rhs(Fe_src + dirichlet_rhs_correction(Ke, ubc_e),
                         pattern)
        return A, b

    assemble.pattern = pattern
    return assemble, time.perf_counter() - t0


def _point_loads(dofmap, force_bc) -> np.ndarray:
    """Nodal ForceBC rows -> reduced rhs vector (row-ownership guard as in
    triaelasticityparallelimpl1.F:976-987)."""
    fvec = np.zeros(dofmap.total_dof, dtype=np.float64)
    if force_bc is not None and len(force_bc):
        rows = dofmap.node_dof[force_bc[:, 0].astype(np.int64),
                               force_bc[:, 1].astype(np.int64)]
        keep = rows >= 0
        np.add.at(fvec, rows[keep], force_bc[keep, 2])
    return fvec


def solve_implicit(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    force_bc: Optional[np.ndarray] = None,
    dtype=None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    maxiter: Optional[int] = None,
    method: str = "cg",
    refine: bool = False,
    recover: bool = True,
    precond: str = "jacobi",
) -> ImplicitResult:
    """Assemble and solve K u = F for one element kernel.

    Args:
      element_fn: coords_e (E,npe,ndim) -> (Ke (E,ns,ns), Fe_src (E,ns)).
      dirichlet:  (n,3) [node, dof, value] rows (0-based).
      force_bc:   optional (n,3) nodal point loads added to the rhs
                  (the reference's ForceBC files).
      method:     'cg' (reference default, solverpetsc.F:187) or 'bicgstab'.
      refine:     mixed-precision iterative refinement — f32 inner CG with a
                  f64 residual loop reaching rtol in TRUE f64 residual (the
                  path to the reference's double-precision 1e-8 target;
                  solve/refine.py).  Ignores `dtype` and `method`.
      recover:    when a structure-less mesh's diagonal census fails the DIA
                  threshold, try the geometric lexicographic renumbering
                  (mesh/reorder.py) that restores the gather-free SpMV for
                  permuted lattice meshes; the solution is mapped back to
                  the caller's numbering.
    """
    if recover and mesh.structure is None and not refine:
        from pfemfort_jax.mesh.reorder import recover_structure

        rec = recover_structure(mesh, ndof, dirichlet, force_bc)
        if rec is not None:
            mesh2, dbc2, fbc2, perm, dofmap0 = rec
            res = solve_implicit(
                mesh2, ndof, dbc2, element_fn, force_bc=fbc2, dtype=dtype,
                rtol=rtol, atol=atol, maxiter=maxiter, method=method,
                recover=False, precond=precond)
            u_full = res.u_full.reshape(mesh.n_node, ndof)[perm].reshape(-1)
            timings = dict(res.timings, structure_recovered=True)
            return ImplicitResult(
                u_full=u_full,
                u_reduced=jnp.asarray(u_full[dofmap0.assy_for_soln]),
                stats=res.stats,
                timings=timings,
            )
    if refine:
        return _solve_implicit_refined(
            mesh, ndof, dirichlet, element_fn, force_bc=force_bc,
            rtol=rtol, maxiter=maxiter)
    if dtype is None:
        dtype = jnp.zeros(0).dtype  # respect jax_enable_x64
    t0 = time.perf_counter()
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    assemble_reduced, t_extra = build_reduced_assembler(
        mesh, ndof, dofmap, element_fn, dtype)
    t_pattern = time.perf_counter() - t0

    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()),
                            dtype=dtype)
    fvec = jnp.asarray(_point_loads(dofmap, force_bc), dtype=dtype)

    if maxiter is None:
        maxiter = max(10 * dofmap.total_dof, 1000)
    from pfemfort_jax.solve.gmres import gmres_solve
    solver = {"cg": cg_solve, "bicgstab": bicgstab_solve,
              "gmres": gmres_solve}[method]

    t1 = time.perf_counter()
    A, b = jax.block_until_ready(jax.jit(assemble_reduced)(coords_em))
    t_asm = time.perf_counter() - t1
    requested = precond
    pc_tree = None
    if precond in ("ic0", "amg"):
        # Preconditioners whose setup needs HOST matrix values.  'ic0' =
        # IC(0) with truncated-Neumann application (solve/ic0.py; the
        # reference's serial PC=ILU, triapoissonserialimpl1.F:696).  'amg' =
        # smoothed-aggregation algebraic multigrid (solve/amg.py; the
        # PC=hypre options-file escape hatch, solverpetsc.F:198-209, for
        # meshes with no lattice at all).  Falls back to Jacobi LOUDLY
        # (precond_used) when the setup cannot cover this system.
        from pfemfort_jax.solve.ic0 import _csr_from_matrix

        indptr, indices, vals_h, n0 = _csr_from_matrix(
            A, getattr(assemble_reduced, "pattern", None))
        if precond == "ic0":
            from pfemfort_jax.solve.amg_device import build_ic0_device
            from pfemfort_jax.solve.ic0 import build_ic0_from_csr

            arrs = build_ic0_from_csr(indptr, indices, vals_h, n0,
                                      dtype=dtype)
            if arrs is not None:
                pc_tree = build_ic0_device(arrs, dtype=dtype)
        else:
            from pfemfort_jax.solve.amg import build_samg
            from pfemfort_jax.solve.amg_device import build_samg_device

            built = build_samg(indptr, indices, vals_h, n0, ndof=ndof,
                               dtype=dtype)
            if built is not None:
                arrs, amg_meta = built
                pc_tree = build_samg_device(arrs, amg_meta.sizes,
                                            dtype=dtype)
        if pc_tree is None:
            precond = "jacobi"

    @jax.jit
    def solve(A, b, pc_tree):
        operator, diag = operator_and_diag(A)
        if precond == "ic0":
            from pfemfort_jax.solve.amg_device import (
                ic0_device_preconditioner)
            pre = ic0_device_preconditioner(pc_tree)
        elif precond == "amg":
            from pfemfort_jax.solve.amg_device import (
                samg_device_preconditioner)
            pre = samg_device_preconditioner(pc_tree, amg_meta, operator)
        elif precond == "cheby":
            # Chebyshev polynomial of D^{-1}A, a matrix-free stand-in for
            # the reference's serial-driver PC=ILU
            # (triapoissonserialimpl1.F:696); see solve/precond.py
            from pfemfort_jax.solve.precond import chebyshev_preconditioner
            pre = chebyshev_preconditioner(operator, diag)
        else:
            pre = jacobi_preconditioner(diag)
        return solver(operator, b, precond=pre, rtol=rtol, atol=atol,
                      maxiter=maxiter)

    t1 = time.perf_counter()
    u, stats = solve(A, b + fvec, pc_tree)
    u = jax.block_until_ready(u)
    t_solve = time.perf_counter() - t1

    u_full = dofmap.expand_solution(np.asarray(u, dtype=np.float64))
    return ImplicitResult(
        u_full=u_full,
        u_reduced=u,
        stats=jax.tree.map(lambda a: np.asarray(a), stats),
        timings=dict(pattern_s=t_pattern, assemble_s=t_asm,
                     solve_s=t_solve, precond_requested=requested,
                     precond_used=precond),
    )


def solve_implicit_fullsystem(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    force_bc: Optional[np.ndarray] = None,
    dtype=None,
    rtol: float = 1e-8,
    maxiter: Optional[int] = None,
    method: str = "cg",
    precond: str = "jacobi",
    refine: bool = False,
) -> ImplicitResult:
    """serialimpl3-parity path: full-size DOF system + MatZeroRows BCs
    (/root/reference/src/triapoissonserialimpl3.F:351-359, 557-558).

    Advantage of this mode: no reduced renumbering, so structured meshes
    keep their pristine lattice offsets (often fewer DIA offsets than the
    reduced system) and the solution vector maps 1:1 to node-dofs.

    precond: 'jacobi' (reference-default class) or 'mg' — geometric
    multigrid V-cycle on structured lattices (the PC=hypre analog the
    reference offers via its options file; solve/multigrid.py).  'mg'
    silently falls back to Jacobi when the mesh has no lattice structure.
    """
    from pfemfort_jax.assembly.fullsystem import zero_dirichlet_rows
    from pfemfort_jax.solve.gmres import gmres_solve

    if dtype is None:
        dtype = jnp.zeros(0).dtype
    n_full = mesh.n_node * ndof
    t0 = time.perf_counter()
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    # Structured box-tet meshes skip the pattern build entirely: assembly is
    # 96 static slice-adds into the node lattice (assembly/structured.py).
    kind = (mesh.structure or {}).get("kind")
    structured = kind in ("box_tet", "rect_tria") and ndof <= 3
    if structured:
        from pfemfort_jax.assembly import structured as st

        if kind == "box_tet":
            plan = st.build_structured_plan(
                mesh.structure["nex"], mesh.structure["ney"],
                mesh.structure["nez"], ndof=ndof)
            assemble_dia_structured = st.assemble_dia_structured
            assemble_rhs_structured = st.assemble_rhs_structured
        else:
            plan = st.build_structured_plan_2d(
                mesh.structure["nex"], mesh.structure["ney"], ndof=ndof)
            assemble_dia_structured = st.assemble_dia_structured_2d
            assemble_rhs_structured = st.assemble_rhs_structured_2d
        pattern = None
    else:
        # full system: every element slot keeps its global node-dof row
        pattern = build_pattern(dofmap.elem_nodedof, n_full)
    t_pattern = time.perf_counter() - t0

    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()),
                            dtype=dtype)
    bc_mask = jnp.asarray(~dofmap.free_mask_full())
    bc_vals = jnp.asarray(dofmap.bc_values_full, dtype=dtype)

    fvec = np.zeros(n_full, dtype=np.float64)
    if force_bc is not None and len(force_bc):
        idx = (force_bc[:, 0].astype(np.int64) * ndof
               + force_bc[:, 1].astype(np.int64))
        np.add.at(fvec, idx, force_bc[:, 2])
    fvec = jnp.asarray(fvec, dtype=dtype)

    if maxiter is None:
        maxiter = max(10 * n_full, 1000)
    solver = {"cg": cg_solve, "bicgstab": bicgstab_solve,
              "gmres": gmres_solve}[method]

    mg = None
    t1 = time.perf_counter()
    if precond == "mg" and structured:
        from pfemfort_jax.solve.multigrid import build_gmg, gmg_preconditioner

        mg = build_gmg(mesh, ndof, np.asarray(bc_mask), element_fn,
                       dtype=dtype)
    t_mg = time.perf_counter() - t1

    @jax.jit
    def assemble_and_solve(coords_em, bc_vals, fvec, mg_arrays):
        Ke, Fe_src = element_fn(coords_em)
        if structured:
            A = assemble_dia_structured(Ke, plan)
            b = assemble_rhs_structured(Fe_src, plan) + fvec
        else:
            A = assemble_matrix(Ke, pattern)
            b = assemble_rhs(Fe_src, pattern) + fvec
        A, b = zero_dirichlet_rows(A, b, bc_mask, bc_vals)
        operator, diag = operator_and_diag(A)
        if mg_arrays is not None:
            pc = gmg_preconditioner(mg_arrays, mg[1])
        else:
            pc = jacobi_preconditioner(diag)
        # start from the BC values so BC residual components vanish (the
        # property that lets the reference run CG on this system)
        x0 = jnp.where(bc_mask, bc_vals, 0.0)
        u, stats = solver(
            operator, b, x0=x0,
            precond=pc,
            rtol=rtol, maxiter=maxiter)
        return u, stats

    t1 = time.perf_counter()
    u, stats = assemble_and_solve(coords_em, bc_vals, fvec,
                                  mg[0] if mg is not None else None)
    u = jax.block_until_ready(u)
    t_solve = time.perf_counter() - t1

    u_full = np.asarray(u, dtype=np.float64)
    return ImplicitResult(
        u_full=u_full,
        u_reduced=u,
        stats=jax.tree.map(lambda a: np.asarray(a), stats),
        timings=dict(pattern_s=t_pattern, mg_setup_s=t_mg, solve_s=t_solve),
    )


def _solve_implicit_refined(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    element_fn: Callable,
    force_bc: Optional[np.ndarray] = None,
    rtol: float = 1e-8,
    maxiter: Optional[int] = None,
) -> ImplicitResult:
    """Mixed-precision path to the reference's f64 1e-8 target.

    The f64 system is assembled ONCE on the host CPU backend (f64 without
    jax_enable_x64 on the accelerator, no accelerator compile; moving this
    f64 work onto the card is an open item); the refinement loop then
    runs on the accelerator entirely in f32 with a compensated double-float
    (f32x2) outer residual (solve/refine.py:cg_with_refinement_df).  ELL
    (unstructured) systems keep the emulated-f64 outer loop."""
    from pfemfort_jax.solve.refine import cg_with_refinement, \
        cg_with_refinement_df
    from pfemfort_jax.sparse.dia import DIAMatrix

    t0 = time.perf_counter()
    dofmap = build_dofmap(mesh, ndof, dirichlet)

    cpu = jax.local_devices(backend="cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        assemble64, _ = build_reduced_assembler(
            mesh, ndof, dofmap, element_fn, jnp.float64)
        coords64 = jax.device_put(to_element_minor(mesh.elem_coords()), cpu)
        A64, b64 = jax.jit(assemble64)(coords64)
        vals64 = np.asarray(A64.vals, dtype=np.float64)
        b64h = (np.asarray(b64, dtype=np.float64)
                + _point_loads(dofmap, force_bc))
    t_pattern = time.perf_counter() - t0

    if maxiter is None:
        maxiter = max(10 * dofmap.total_dof, 1000)

    if isinstance(A64, DIAMatrix):
        A32 = DIAMatrix(vals=jnp.asarray(vals64, dtype=jnp.float32),
                        offsets=A64.offsets, n_rows=A64.n_rows,
                        lattice=A64.lattice)
        op32, diag32 = operator_and_diag(A32)
        t1 = time.perf_counter()
        x_host, rstats = cg_with_refinement_df(
            A64.offsets, vals64, b64h, op32=op32,
            precond32=jacobi_preconditioner(diag32),
            rtol=rtol, inner_maxiter=maxiter)
        t_solve = time.perf_counter() - t1
    else:
        with jax.enable_x64(True):
            op64, _ = operator_and_diag(A64)
            A32 = jax.tree.map(
                lambda a: jnp.asarray(np.asarray(a), jnp.float32)
                if jnp.issubdtype(a.dtype, jnp.floating) else a, A64)
            op32, diag32 = operator_and_diag(A32)
            t1 = time.perf_counter()
            x64, rstats = cg_with_refinement(
                op64, op32, jnp.asarray(b64h),
                precond32=jacobi_preconditioner(diag32),
                rtol=rtol, inner_maxiter=maxiter)
            x_host = np.asarray(x64, dtype=np.float64)
            t_solve = time.perf_counter() - t1

    stats = SolveStats(
        iters=np.int32(rstats.total_inner_iters),
        relres=np.float64(rstats.relres),
        converged=np.bool_(rstats.converged))
    # u_full from the host float64 copy: without jax_enable_x64 a device
    # array of the solution would be rounded to float32
    u_full = dofmap.expand_solution(x_host)
    return ImplicitResult(
        u_full=u_full,
        u_reduced=jnp.asarray(x_host),
        stats=stats,
        timings=dict(pattern_s=t_pattern, solve_s=t_solve,
                     outer_iters=rstats.outer_iters),
    )
