"""Geometric multigrid preconditioner for structured lattice systems.

The reference exposes PC=hypre (algebraic multigrid) through its PETSc
options file (/root/reference/src/solverpetsc.F:1-8, 206-209) as the
scalable alternative to block-Jacobi.  Here the natural equivalent for
the generated benchmark meshes (box tets / rect trias on a node lattice,
mesh/generate.py) is GEOMETRIC multigrid: every component is a dense
lattice operation —

  * level operators: DIA matrices from the scatter-free structured assembly
    (assembly/structured.py), with Dirichlet rows AND columns symmetrized to
    identity so the V-cycle stays SPD on the free subspace;
  * smoother: damped Jacobi (elementwise FMAs);
  * transfers: axis-separable linear interpolation and its exact adjoint
    (strided slices + adds — no gathers);
  * coarsest level: precomputed dense inverse applied as one small matmul.

Used as the preconditioner inside `cg_solve` on the full-size node-dof
system (assembly/fullsystem.py), where the BC components of the residual
are exactly zero every iteration, so masking Dirichlet entries keeps the
cycle linear and symmetric.  O(N) setup, O(1) condition number: iteration
counts stay ~10 as the mesh is refined, versus O(n) growth for Jacobi-CG.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.sparse.dia import DIAMatrix, dia_diagonal


# ---------------------------------------------------------------------------
# transfers: separable linear interpolation on a node lattice
# ---------------------------------------------------------------------------

def interp_axis(u: jnp.ndarray, axis: int) -> jnp.ndarray:
    """(..., nc, ...) -> (..., 2*nc-1, ...): even = copy, odd = midpoint."""
    u = jnp.moveaxis(u, axis, -1)
    mid = 0.5 * (u[..., :-1] + u[..., 1:])
    pairs = jnp.stack([u[..., :-1], mid], axis=-1)
    pairs = pairs.reshape(*u.shape[:-1], 2 * (u.shape[-1] - 1))
    out = jnp.concatenate([pairs, u[..., -1:]], axis=-1)
    return jnp.moveaxis(out, -1, axis)


def restrict_axis(f: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Exact adjoint of `interp_axis`: c[i] = f[2i] + (f[2i-1]+f[2i+1])/2."""
    f = jnp.moveaxis(f, axis, -1)
    ev = f[..., 0::2]
    od = f[..., 1::2]
    pad = [(0, 0)] * (f.ndim - 1)
    c = ev + 0.5 * (jnp.pad(od, pad + [(0, 1)])
                    + jnp.pad(od, pad + [(1, 0)]))
    return jnp.moveaxis(c, -1, axis)


def prolong(ec: jnp.ndarray, coarse_shape: Tuple[int, ...],
            ndof: int) -> jnp.ndarray:
    """Coarse flat vector -> fine flat vector (tri/bi-linear)."""
    u = ec.reshape(*coarse_shape, ndof)
    for ax in range(len(coarse_shape)):
        u = interp_axis(u, ax)
    return u.reshape(-1)


def restrict(rf: jnp.ndarray, fine_shape: Tuple[int, ...],
             ndof: int) -> jnp.ndarray:
    """Fine flat residual -> coarse flat residual (adjoint of `prolong`)."""
    u = rf.reshape(*fine_shape, ndof)
    for ax in range(len(fine_shape)):
        u = restrict_axis(u, ax)
    return u.reshape(-1)


# ---------------------------------------------------------------------------
# level construction
# ---------------------------------------------------------------------------

class GMGArrays(NamedTuple):
    """Per-level device data (a pytree; passed through jit boundaries).

    mats[l] has Dirichlet rows AND columns set to identity (the symmetric
    variant of fullsystem.zero_dirichlet_rows), masks[l] is 1.0 on free
    node-dofs and 0.0 on Dirichlet ones, coarse_inv is the dense inverse of
    the coarsest symmetrized operator.
    """
    mats: Tuple[DIAMatrix, ...]
    inv_diags: Tuple[jnp.ndarray, ...]
    masks: Tuple[jnp.ndarray, ...]
    coarse_inv: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class GMGMeta:
    """Static cycle metadata (captured in closures, never traced)."""
    shapes: Tuple[Tuple[int, ...], ...]   # node-lattice shape per level
    ndof: int
    nu: int          # pre/post smoothing sweeps (equal -> symmetric cycle)
    omega: float     # Jacobi damping
    # (lmax, lmin, degree) of a Chebyshev coarse solve when the coarsening
    # chain sticks on an odd dimension above the dense-inverse cap (e.g.
    # 200 -> 100 -> 50 -> 25 stalls at 17.6k dofs); a fixed polynomial of
    # the Jacobi-scaled coarse operator is linear and SPD, so CG stays valid
    coarse_cheby: Optional[Tuple[float, float, int]] = None


def symmetrize_dirichlet(A: DIAMatrix, bc_mask: np.ndarray) -> DIAMatrix:
    """Identity Dirichlet rows and columns (keeps the operator SPD).

    Unlike fullsystem.zero_dirichlet_rows (PETSc MatZeroRows parity: rows
    only), the preconditioner wants full symmetry; with masked residuals the
    two agree on the free subspace.
    """
    n = A.n_rows
    row_bc = jnp.asarray(bc_mask)
    new_vals = []
    for d, o in enumerate(A.offsets):
        # column index of entry (r, r+o) is BC?
        col = np.arange(n) + o
        col_bc_np = np.zeros(n, dtype=bool)
        valid = (col >= 0) & (col < n)
        col_bc_np[valid] = bc_mask[col[valid]]
        col_bc = jnp.asarray(col_bc_np)
        if o == 0:
            new_vals.append(jnp.where(row_bc, 1.0, A.vals[d]))
        else:
            new_vals.append(
                jnp.where(row_bc | col_bc, 0.0, A.vals[d]))
    return A._replace(vals=jnp.stack(new_vals))


def _coarse_box_mesh(mesh: Mesh) -> Tuple[Mesh, dict]:
    """Halve a structured mesh by subsampling its node lattice."""
    from pfemfort_jax.mesh import generate as gen

    st = dict(mesh.structure)
    kind = st["kind"]
    if kind == "box_tet":
        nex, ney, nez = st["nex"] // 2, st["ney"] // 2, st["nez"] // 2
        shape = (st["nez"] + 1, st["ney"] + 1, st["nex"] + 1)
        coords = mesh.coords.reshape(*shape, 3)[::2, ::2, ::2].reshape(-1, 3)
        cm, _ = gen.box_tet(0, 1, nex, 0, 1, ney, 0, 1, nez)
        coarse = Mesh("tetra4", coords, cm.conn,
                      structure=dict(kind=kind, nex=nex, ney=ney, nez=nez))
    elif kind == "rect_tria":
        nex, ney = st["nex"] // 2, st["ney"] // 2
        shape = (st["ney"] + 1, st["nex"] + 1)
        coords = mesh.coords.reshape(*shape, 2)[::2, ::2].reshape(-1, 2)
        cm = gen.rect_tria(0, 1, nex, 0, 1, ney)
        coarse = Mesh("tria3", coords, cm.conn,
                      structure=dict(kind=kind, nex=nex, ney=ney))
    else:  # pragma: no cover - guarded by caller
        raise ValueError(f"unsupported structure kind {kind!r}")
    return coarse, coarse.structure


def _lattice_shape(structure: dict) -> Tuple[int, ...]:
    if structure["kind"] == "box_tet":
        return (structure["nez"] + 1, structure["ney"] + 1,
                structure["nex"] + 1)
    return (structure["ney"] + 1, structure["nex"] + 1)


def _is_affine_box(mesh: Mesh) -> Optional[Tuple[Tuple[float, float], ...]]:
    """Bounds per axis when the node coords ARE the separable affine
    lattice (so they can be regenerated on device); None otherwise."""
    s = mesh.structure
    shape = (s["nez"] + 1, s["ney"] + 1, s["nex"] + 1)
    c = mesh.coords.reshape(*shape, 3)
    lo = mesh.coords.min(axis=0)
    hi = mesh.coords.max(axis=0)
    for ax, nn in ((0, shape[2]), (1, shape[1]), (2, shape[0])):
        axis_dim = {0: 2, 1: 1, 2: 0}[ax]
        want = np.linspace(lo[ax], hi[ax], c.shape[axis_dim])
        sl = [0, 0, 0, ax]
        sl[axis_dim] = slice(None)
        if not np.allclose(c[tuple(sl)], want, atol=1e-12 + 1e-9 *
                           max(abs(lo[ax]), abs(hi[ax]))):
            return None
        # separability: the coordinate must not vary along the other axes
        var = c[..., ax]
        red = tuple(d for d in range(3) if d != axis_dim)
        if float(np.abs(var.max(axis=red) - var.min(axis=red)).max()) > 1e-9:
            return None
    return tuple((float(lo[a]), float(hi[a])) for a in range(3))


def _assemble_level(mesh: Mesh, ndof: int, element_fn: Callable,
                    dtype, bc_mask: np.ndarray) -> DIAMatrix:
    """One jit-compiled call per level: element matrices -> structured
    slice-add assembly -> BC symmetrization.

    For affine box lattices the element-minor coords are generated ON
    DEVICE (no host gather and transfer of the level-1 coords, ~290 MB at
    the 48M problem)."""
    from pfemfort_jax.assembly import structured as st
    from pfemfort_jax.elements.geometry import to_element_minor

    s = mesh.structure
    if s["kind"] == "box_tet":
        plan = st.build_structured_plan(s["nex"], s["ney"], s["nez"],
                                        ndof=ndof)
        assemble = st.assemble_dia_structured
        bounds = _is_affine_box(mesh)
        if bounds is not None:
            from pfemfort_jax.mesh import generate as gen

            (x0, x1), (y0, y1), (z0, z1) = bounds

            @jax.jit
            def build_dev():
                coords_em = gen.box_tet_coords_em_device(
                    x0, x1, s["nex"], y0, y1, s["ney"],
                    z0, z1, s["nez"], dtype=dtype)
                Ke, _ = element_fn(coords_em)
                return symmetrize_dirichlet(assemble(Ke, plan), bc_mask)

            return build_dev()
    else:
        plan = st.build_structured_plan_2d(s["nex"], s["ney"], ndof=ndof)
        assemble = st.assemble_dia_structured_2d

    coords_em = jnp.asarray(to_element_minor(mesh.elem_coords()), dtype=dtype)

    @jax.jit
    def build(coords_em):
        Ke, _ = element_fn(coords_em)
        return symmetrize_dirichlet(assemble(Ke, plan), bc_mask)

    return build(coords_em)


def _dia_to_dense(A: DIAMatrix) -> np.ndarray:
    n = A.n_rows
    dense = np.zeros((n, n), dtype=np.float64)
    vals = np.asarray(A.vals, dtype=np.float64)
    for d, o in enumerate(A.offsets):
        rows = np.arange(max(0, -o), min(n, n - o))
        dense[rows, rows + o] = vals[d, rows]
    return dense


def build_gmg(
    mesh: Mesh,
    ndof: int,
    bc_mask_full: np.ndarray,
    element_fn: Callable,
    dtype=jnp.float32,
    nu: int = 1,
    omega: float = 0.8,
    coarsest_max_dof: int = 4096,
    min_cells: int = 2,
    fine_matrix: Optional[DIAMatrix] = None,
) -> Optional[Tuple[GMGArrays, GMGMeta]]:
    """Build the multigrid hierarchy for a structured mesh.

    Returns None when the mesh has no recognized lattice structure or the
    coarsening chain cannot reach a dense-invertible coarsest level (the
    caller then falls back to Jacobi).  `bc_mask_full` is the (n_node*ndof,)
    Dirichlet mask of the FINE full system.

    `fine_matrix`: optional pre-assembled AND pre-symmetrized (identity BC
    rows+columns) FULL-system fine-level DIA — skips the fine-level element
    assembly, which at 48M elements is the only expensive level.  Callers
    with host f64 values symmetrize there (assembly/stencil64.py flow) so no
    mask constants are baked into the compiled program.
    """
    st = mesh.structure or {}
    if st.get("kind") not in ("box_tet", "rect_tria"):
        return None

    # --- coarsening chain (host side) ---
    meshes = [mesh]
    masks_np = [np.asarray(bc_mask_full, dtype=bool)]
    while True:
        s = meshes[-1].structure
        dims = ([s["nex"], s["ney"], s["nez"]] if s["kind"] == "box_tet"
                else [s["nex"], s["ney"]])
        n_dof_here = int(np.prod([d + 1 for d in dims])) * ndof
        if n_dof_here <= coarsest_max_dof:
            break
        if any(d % 2 or d // 2 < min_cells for d in dims):
            break
        coarse, _ = _coarse_box_mesh(meshes[-1])
        shape = _lattice_shape(s)
        sub = masks_np[-1].reshape(*shape, ndof)
        sub = sub[(slice(None, None, 2),) * len(shape)]
        meshes.append(coarse)
        masks_np.append(sub.reshape(-1))

    n_coarsest = meshes[-1].n_node * ndof
    use_cheby = n_coarsest > coarsest_max_dof
    if use_cheby and n_coarsest > (1 << 18):
        return None  # stuck on an odd dimension while genuinely too big

    # --- per-level operators ---
    mats, inv_diags, masks = [], [], []
    for li, (m, bm) in enumerate(zip(meshes, masks_np)):
        if li == 0 and fine_matrix is not None:
            A = fine_matrix
        else:
            A = _assemble_level(m, ndof, element_fn, dtype, bm)
        d = dia_diagonal(A)
        mats.append(A)
        inv_diags.append(jnp.where(d != 0, 1.0 / d, 0.0).astype(dtype))
        masks.append(jnp.asarray(~bm, dtype=dtype))

    coarse_cheby = None
    if use_cheby:
        Ac = mats[-1]
        # Gershgorin upper bound on the Jacobi-scaled spectrum — a SAFE
        # lmax (power iteration underestimates on clustered spectra, and
        # Chebyshev diverges violently for eigenvalues above its interval)
        d = dia_diagonal(Ac)
        absrow = jnp.sum(jnp.abs(Ac.vals), axis=0)
        lmax = float(jnp.max(jnp.where(d > 0, absrow / d, 1.0)))
        # lmin well under the coarse lattice's true smallest eigenvalue;
        # degree ~48 reaches ~1e-3 coarse accuracy, plenty for the V-cycle
        coarse_cheby = (lmax, lmax / 200.0, 48)
        coarse_inv = jnp.zeros((1, 1), dtype=dtype)   # placeholder leaf
    else:
        coarse_inv = jnp.asarray(
            np.linalg.inv(_dia_to_dense(mats[-1])), dtype=dtype)

    arrays = GMGArrays(mats=tuple(mats), inv_diags=tuple(inv_diags),
                       masks=tuple(masks), coarse_inv=coarse_inv)
    meta = GMGMeta(
        shapes=tuple(_lattice_shape(m.structure) for m in meshes),
        ndof=ndof, nu=nu, omega=omega, coarse_cheby=coarse_cheby)
    return arrays, meta


# ---------------------------------------------------------------------------
# the V-cycle
# ---------------------------------------------------------------------------

def _vcycle(arrays: GMGArrays, meta: GMGMeta, level: int,
            r: jnp.ndarray, ops, coarse_apply=None) -> jnp.ndarray:
    """One V(nu, nu) cycle on level `level`; assumes r == 0 on BC entries."""
    last = len(arrays.mats) - 1
    if level == last:
        if coarse_apply is not None:
            return coarse_apply(r)
        return jnp.dot(arrays.coarse_inv, r,
                       precision=jax.lax.Precision.HIGHEST)

    spmv = ops[level]
    Dinv = arrays.inv_diags[level]
    m = arrays.masks[level]
    om = meta.omega

    e = om * Dinv * r
    for _ in range(meta.nu - 1):
        e = e + om * Dinv * (r - spmv(e))

    rc = arrays.masks[level + 1] * restrict(
        m * (r - spmv(e)), meta.shapes[level], meta.ndof)
    ec = _vcycle(arrays, meta, level + 1, rc, ops, coarse_apply)
    e = e + m * prolong(ec, meta.shapes[level + 1], meta.ndof)

    for _ in range(meta.nu):
        e = e + om * Dinv * (r - spmv(e))
    return e


def gmg_preconditioner(arrays: GMGArrays, meta: GMGMeta) -> Callable:
    """r -> M^{-1} r: one symmetric V-cycle on the free subspace, identity
    on Dirichlet entries (matching the full-system identity BC rows).

    Level SpMV operators are built here, once per solve trace.
    """
    from pfemfort_jax.sparse.ops import matvec

    fine_mask = arrays.masks[0]
    ops = tuple(matvec(A) for A in arrays.mats)

    coarse_apply = None
    if meta.coarse_cheby is not None:
        from pfemfort_jax.solve.precond import chebyshev_preconditioner

        lmax, lmin, deg = meta.coarse_cheby
        inv_d = arrays.inv_diags[-1]
        diag_c = jnp.where(inv_d != 0, 1.0 / inv_d, 1.0)
        coarse_apply = chebyshev_preconditioner(
            ops[-1], diag_c, lmax=lmax, lmin=lmin, degree=deg)

    def precond(r):
        z = _vcycle(arrays, meta, 0, fine_mask * r, ops, coarse_apply)
        # identity on BC components (they are zero throughout full-system
        # CG started from x0 = bc values, but keep exactness anyway)
        return jnp.where(fine_mask > 0, z, r)

    return precond
