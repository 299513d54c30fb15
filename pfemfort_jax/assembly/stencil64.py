"""Exact f64 assembly of generator box-tet systems as a constant stencil
(host-side numpy).

The reference's flagship assembles 48M tetra elements in full double
precision across 40 MPI ranks (/root/reference/src/tetrapoissonparallelimpl1.F
hot loop, README.md:19-21).  Device f64 assembly at that size is costly — but
for the generator's UNIFORM box lattice every hex cell is congruent, so all
48M element matrices are translates of the SAME six 4x4 matrices.  The
exact f64 system is therefore:

    vals[d, z, y, x] = sum of a handful of CONSTANTS (one per
                       (class, i, j) entry landing on diagonal d)

assembled by ~96 numpy slice-adds over the (D, nnz, nny, nnx) value lattice
— a few seconds of host time for the 48M-element system, no device f64, no
per-element storage.  The six constant matrices come from the SAME element
kernels the framework uses everywhere (evaluated once on the CPU backend in
f64), so this is the exact matrix the general f64 assembly would produce up
to the ~1e-16 coordinate-rounding noise between congruent cells.

Feeds the double-float refinement (solve/highprec.py) that reaches the
reference's 1e-8 double-precision residual target at the 48M scale.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from pfemfort_jax.assembly.structured import (
    StructuredPlan,
    build_structured_plan,
)
from pfemfort_jax.mesh.core import Mesh


def stencil_full_system_f64(
    mesh: Mesh,
    element_fn: Optional[Callable] = None,
    source: float = -6.0,
) -> Tuple[Tuple[int, ...], np.ndarray, np.ndarray]:
    """Exact f64 FULL-system (all node-dofs) Poisson DIA for a box_tet mesh.

    Returns (offsets, vals (D, n) f64, rhs (n,) f64) — no BCs applied yet
    (compose with `zero_rows_f64`).  ndof=1 only.
    """
    import jax
    import jax.numpy as jnp

    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.elements.poisson import poisson_element_matrices

    st = mesh.structure or {}
    if st.get("kind") != "box_tet":
        raise ValueError("stencil f64 assembly needs a box_tet mesh")
    nex, ney, nez = st["nex"], st["ney"], st["nez"]
    nnx, nny, nnz_ = nex + 1, ney + 1, nez + 1
    plan = build_structured_plan(nex, ney, nez, ndof=1)
    D = len(plan.offsets)

    # the six congruent element matrices, in f64, from the first hex
    ce6 = to_element_minor(mesh.elem_coords()[:6])       # (4, 3, 6)
    if element_fn is None:
        element_fn = lambda c: poisson_element_matrices(
            c, "tetra4", source=source)
    cpu = jax.local_devices(backend="cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        Ke6, Fe6 = element_fn(jnp.asarray(ce6, dtype=jnp.float64))
    Ke6 = np.asarray(Ke6, dtype=np.float64)              # (4, 4, 6)
    Fe6 = np.asarray(Fe6, dtype=np.float64)              # (4, 6)

    vals = np.zeros((D, nnz_, nny, nnx), dtype=np.float64)
    rhs = np.zeros((nnz_, nny, nnx), dtype=np.float64)
    for (c, nr, nc, d, rz, ry, rx, ci) in plan.entries:
        vals[d, rz:rz + nez, ry:ry + ney, rx:rx + nex] += Ke6[nr, nc, c]
    for (c, nr, rz, ry, rx, ci) in plan.rhs_entries:
        rhs[rz:rz + nez, ry:ry + ney, rx:rx + nex] += Fe6[nr, c]

    n = nnz_ * nny * nnx
    return plan.offsets, vals.reshape(D, n), rhs.reshape(n)


def stencil_full_system_df_device(
    mesh: Mesh,
    element_fn: Optional[Callable] = None,
    source: float = -6.0,
):
    """Device-built DOUBLE-FLOAT full system for a box_tet mesh: the same
    ~96 constant slice-adds as `stencil_full_system_f64`, executed on
    device in compensated (hi, lo) f32 arithmetic (TwoSum per add).

    Eliminates the host f64 build (~30 s at 48M) AND the ~1 GB (hi, lo)
    upload.  Accuracy: DF accumulation of <=32
    terms carries ~2^-47 relative error vs the exact-f64-then-split path's
    2^-49 — both orders of magnitude below the 1e-8 refinement target
    (validated bit-close by tests/test_highprec.py).

    Returns (offsets, (vals_hi, vals_lo) (D, n) f32 device arrays,
    (rhs_hi, rhs_lo) (n,) f32 device arrays).
    """
    import jax
    import jax.numpy as jnp

    from pfemfort_jax.elements.geometry import to_element_minor
    from pfemfort_jax.elements.poisson import poisson_element_matrices
    from pfemfort_jax.solve.doublefloat import _quick_two_sum, _two_sum

    st = mesh.structure or {}
    if st.get("kind") != "box_tet":
        raise ValueError("stencil DF assembly needs a box_tet mesh")
    nex, ney, nez = st["nex"], st["ney"], st["nez"]
    nnx, nny, nnz_ = nex + 1, ney + 1, nez + 1
    plan = build_structured_plan(nex, ney, nez, ndof=1)
    D = len(plan.offsets)

    ce6 = to_element_minor(mesh.elem_coords()[:6])
    if element_fn is None:
        element_fn = lambda c: poisson_element_matrices(
            c, "tetra4", source=source)
    import jax as _jax
    cpu = _jax.local_devices(backend="cpu")[0]
    with _jax.enable_x64(True), _jax.default_device(cpu):
        Ke6, Fe6 = element_fn(jnp.asarray(ce6, dtype=jnp.float64))
    Ke6 = np.asarray(Ke6, dtype=np.float64)
    Fe6 = np.asarray(Fe6, dtype=np.float64)
    KH = Ke6.astype(np.float32)
    KL = (Ke6 - KH.astype(np.float64)).astype(np.float32)
    FH = Fe6.astype(np.float32)
    FL = (Fe6 - FH.astype(np.float64)).astype(np.float32)

    entries = plan.entries
    rhs_entries = plan.rhs_entries

    @jax.jit
    def build():
        vh = jnp.zeros((D, nnz_, nny, nnx), jnp.float32)
        vl = jnp.zeros((D, nnz_, nny, nnx), jnp.float32)
        for (c, nr, nc, d, rz, ry, rx, ci) in entries:
            win = (d, slice(rz, rz + nez), slice(ry, ry + ney),
                   slice(rx, rx + nex))
            s, e = _two_sum(vh[win], jnp.float32(KH[nr, nc, c]))
            e = e + (vl[win] + jnp.float32(KL[nr, nc, c]))
            hi, lo = _quick_two_sum(s, e)
            vh = vh.at[win].set(hi)
            vl = vl.at[win].set(lo)
        rh = jnp.zeros((nnz_, nny, nnx), jnp.float32)
        rl = jnp.zeros((nnz_, nny, nnx), jnp.float32)
        for (c, nr, rz, ry, rx, ci) in rhs_entries:
            win = (slice(rz, rz + nez), slice(ry, ry + ney),
                   slice(rx, rx + nex))
            s, e = _two_sum(rh[win], jnp.float32(FH[nr, c]))
            e = e + (rl[win] + jnp.float32(FL[nr, c]))
            hi, lo = _quick_two_sum(s, e)
            rh = rh.at[win].set(hi)
            rl = rl.at[win].set(lo)
        n = nnz_ * nny * nnx
        return (vh.reshape(D, n), vl.reshape(D, n),
                rh.reshape(n), rl.reshape(n))

    vh, vl, rh, rl = build()
    return plan.offsets, (vh, vl), (rh, rl)


def lattice_bc_f64(mesh: Mesh, dirichlet: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(bc_mask (n,), bc_values (n,)) from (node, dof, value) rows, ndof=1 —
    without building the full DofMap (which materializes O(E*npe) arrays the
    structured path never needs)."""
    n = mesh.n_node
    bc_mask = np.zeros(n, dtype=bool)
    bc_vals = np.zeros(n, dtype=np.float64)
    if dirichlet is not None and len(dirichlet):
        nodes = dirichlet[:, 0].astype(np.int64)
        bc_mask[nodes] = True
        bc_vals[nodes] = dirichlet[:, 2]
    return bc_mask, bc_vals


def zero_rows_f64(offsets: Tuple[int, ...], vals: np.ndarray,
                  rhs: np.ndarray, bc_mask: np.ndarray,
                  bc_values: np.ndarray) -> None:
    """In-place MatZeroRows in f64: BC rows -> identity, rhs[bc] -> value
    (the reference's full-system BC mode, triapoissonserialimpl3.F:557-558)."""
    for d, o in enumerate(offsets):
        vals[d, bc_mask] = 1.0 if o == 0 else 0.0
    rhs[bc_mask] = bc_values[bc_mask]


def symmetrized_f32(offsets: Tuple[int, ...], vals: np.ndarray,
                    bc_mask: np.ndarray) -> np.ndarray:
    """f32 copy of the f64 values with identity BC rows AND columns (the
    SPD form the multigrid smoother wants; solve/multigrid.py:
    symmetrize_dirichlet done host-side so no mask constants are baked into
    a compiled program)."""
    D, n = vals.shape
    out = np.empty((D, n), dtype=np.float32)
    for d, o in enumerate(offsets):
        v = vals[d].astype(np.float32)
        col_bc = np.zeros(n, dtype=bool)
        lo, hi = max(0, -o), min(n, n - o)
        col_bc[lo:hi] = bc_mask[lo + o:hi + o]
        if o == 0:
            v[bc_mask] = 1.0
        else:
            v[bc_mask | col_bc] = 0.0
        out[d] = v
    return out
