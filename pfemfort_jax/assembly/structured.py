"""Structured slice-add assembly: scatter-free stiffness assembly for
generated box-tet meshes.

For the mesh the reference's generator produces (box -> 6 tets per hex,
lexicographic node numbering; genTetranovtk.cpp:203-208), every element
entry's destination is a FIXED lattice shift of the hex index: element
e = (hex, class c), its node i sits at hex_base + corner_offset(c, i), and
the (row, col) pair lands on diagonal offset(c,i,j) at a translated copy of
the hex lattice.  Assembly therefore reduces to 6*npe^2 = 96 STATIC
slice-adds of dense (nez, ney, nex) blocks into the (D, nnz, nny, nnx) DIA
value lattice — no scatters, no gathers, pure streaming adds at HBM
bandwidth.  This is the assembly analog of the DIA SpMV fast path and the
speed-of-light formulation of the reference's MatSetValues loop for its own
benchmark meshes.

Only valid for the FULL node-dof system (rows = lattice node ids), i.e. the
MatZeroRows BC mode (assembly/fullsystem.py).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from pfemfort_jax.mesh.generate import _TET_SPLIT
from pfemfort_jax.sparse.dia import DIAMatrix


class StructuredPlan(NamedTuple):
    nex: int
    ney: int
    nez: int
    ndof: int
    offsets: Tuple[int, ...]          # DIA offsets (flat dof-id differences)
    # per entry: (class, n_row, n_col, d, rz, ry, rx, ci) where n_row/n_col
    # are flat element dof slots (i*ndof+ci, j*ndof+cj)
    entries: Tuple[Tuple[int, int, int, int, int, int, int, int], ...]
    # per (class, n_row, rz, ry, rx, ci) for the rhs
    rhs_entries: Tuple[Tuple[int, int, int, int, int, int], ...]


def _corner_bits(k: int) -> Tuple[int, int, int]:
    """pts[k] of the reference generator: (bx, by, bz) lattice bits."""
    return (k & 1, (k >> 1) & 1, (k >> 2) & 1)


# rect_tria classes (bl,br,tr)+(bl,tr,tl) as (by, bx) lattice corners:
_CLASSES_2D_TRIA = (
    ((0, 0), (0, 1), (1, 1)),
    ((0, 0), (1, 1), (1, 0)),
)


def _generic_plan(classes, dims, strides, ndof):
    """classes: per class, tuple of corner lattice coords (slowest..fastest);
    dims = (nez, ney, nex) or (ney, nex); strides = node-id stride per axis."""
    offsets = set()
    entries = []
    rhs_entries = []
    npe = len(classes[0])
    for c, corners in enumerate(classes):
        for i in range(npe):
            ri = corners[i]
            oi = sum(b * s for b, s in zip(ri, strides))
            for ci in range(ndof):
                rhs_entries.append((c, i * ndof + ci) + tuple(ri) + (ci,))
                for j in range(npe):
                    oj = sum(b * s for b, s in zip(corners[j], strides))
                    for cj in range(ndof):
                        o = (oj - oi) * ndof + (cj - ci)
                        offsets.add(o)
                        entries.append((c, i * ndof + ci, j * ndof + cj, o)
                                       + tuple(ri) + (ci,))
    offs = tuple(sorted(offsets))
    idx = {o: d for d, o in enumerate(offs)}
    entries = tuple(e[:3] + (idx[e[3]],) + e[4:] for e in entries)
    return offs, entries, tuple(rhs_entries)


def build_structured_plan(nex: int, ney: int, nez: int,
                          ndof: int = 1) -> StructuredPlan:
    nnx, nny = nex + 1, ney + 1
    # corners in (bz, by, bx) order, strides (sz, sy, sx)
    classes = tuple(
        tuple(_corner_bits(int(c))[::-1] for c in _TET_SPLIT[cl])
        for cl in range(6))
    offs, entries, rhs_entries = _generic_plan(
        classes, (nez, ney, nex), (nnx * nny, nnx, 1), ndof)
    return StructuredPlan(nex=nex, ney=ney, nez=nez, ndof=ndof,
                          offsets=offs, entries=entries,
                          rhs_entries=rhs_entries)


class StructuredPlan2D(NamedTuple):
    nex: int
    ney: int
    ndof: int
    offsets: Tuple[int, ...]
    entries: Tuple[tuple, ...]      # (class, nr, nc, d, ry, rx, ci)
    rhs_entries: Tuple[tuple, ...]  # (class, nr, ry, rx, ci)


def build_structured_plan_2d(nex: int, ney: int,
                             ndof: int = 1) -> StructuredPlan2D:
    """rect_tria lattice: 2 triangles per cell, node numbering x-fastest."""
    nnx = nex + 1
    offs, entries, rhs_entries = _generic_plan(
        _CLASSES_2D_TRIA, (ney, nex), (nnx, 1), ndof)
    return StructuredPlan2D(nex=nex, ney=ney, ndof=ndof, offsets=offs,
                            entries=entries, rhs_entries=rhs_entries)


def assemble_dia_structured_2d(Ke: jnp.ndarray,
                               plan: StructuredPlan2D) -> DIAMatrix:
    """Ke (ns, ns, E) with e = cell*2 + class -> DIA over the 2D lattice."""
    nex, ney = plan.nex, plan.ney
    nnx, nny = nex + 1, ney + 1
    ndof = plan.ndof
    ns = 3 * ndof
    D = len(plan.offsets)
    n = nnx * nny * ndof
    vals = jnp.zeros((D, nny, nnx, ndof), dtype=Ke.dtype)
    Kc = Ke.reshape(ns, ns, -1, 2)
    for (c, nr, nc, d, ry, rx, ci) in plan.entries:
        blk = Kc[nr, nc, :, c].reshape(ney, nex)
        vals = vals.at[d, ry:ry + ney, rx:rx + nex, ci].add(blk)
    lattice = (nny, nnx) if ndof == 1 else None
    return DIAMatrix(vals=vals.reshape(D, n), offsets=plan.offsets, n_rows=n,
                     lattice=lattice)


def assemble_rhs_structured_2d(Fe: jnp.ndarray,
                               plan: StructuredPlan2D) -> jnp.ndarray:
    nex, ney = plan.nex, plan.ney
    nnx, nny = nex + 1, ney + 1
    ndof = plan.ndof
    ns = 3 * ndof
    rhs = jnp.zeros((nny, nnx, ndof), dtype=Fe.dtype)
    Fc = Fe.reshape(ns, -1, 2)
    for (c, nr, ry, rx, ci) in plan.rhs_entries:
        blk = Fc[nr, :, c].reshape(ney, nex)
        rhs = rhs.at[ry:ry + ney, rx:rx + nex, ci].add(blk)
    return rhs.reshape(-1)


def assemble_dia_structured(Ke: jnp.ndarray,
                            plan: StructuredPlan) -> DIAMatrix:
    """Ke (ns, ns, E) with e = hex*6 + class -> DIA over the node lattice.

    6*ns^2 static slice-adds; zero scatters.  The DIA lattice is viewed as
    (D, nnz, nny, nnx, ndof); entry (class, n_row, n_col) lands on diagonal
    d at the translated hex block for component ci.
    """
    nex, ney, nez = plan.nex, plan.ney, plan.nez
    nnx, nny, nnz_ = nex + 1, ney + 1, nez + 1
    ndof = plan.ndof
    ns = 4 * ndof
    D = len(plan.offsets)
    n = nnx * nny * nnz_ * ndof
    vals = jnp.zeros((D, nnz_, nny, nnx, ndof), dtype=Ke.dtype)
    Kc = Ke.reshape(ns, ns, -1, 6)  # (nr, nc, hex, class); hex = (iz,iy,ix)
    for (c, nr, nc, d, rz, ry, rx, ci) in plan.entries:
        blk = Kc[nr, nc, :, c].reshape(nez, ney, nex)
        vals = vals.at[d, rz:rz + nez, ry:ry + ney, rx:rx + nex, ci].add(blk)
    lattice = (nnz_, nny, nnx) if ndof == 1 else None
    return DIAMatrix(vals=vals.reshape(D, n), offsets=plan.offsets, n_rows=n,
                     lattice=lattice)


def assemble_rhs_structured(Fe: jnp.ndarray,
                            plan: StructuredPlan) -> jnp.ndarray:
    """Fe (ns, E) -> full nodal-dof rhs (n,), 6*ns static slice-adds."""
    nex, ney, nez = plan.nex, plan.ney, plan.nez
    nnx, nny, nnz_ = nex + 1, ney + 1, nez + 1
    ndof = plan.ndof
    ns = 4 * ndof
    rhs = jnp.zeros((nnz_, nny, nnx, ndof), dtype=Fe.dtype)
    Fc = Fe.reshape(ns, -1, 6)
    for (c, nr, rz, ry, rx, ci) in plan.rhs_entries:
        blk = Fc[nr, :, c].reshape(nez, ney, nex)
        rhs = rhs.at[rz:rz + nez, ry:ry + ney, rx:rx + nex, ci].add(blk)
    return rhs.reshape(-1)


def reduce_structured_system(A_full: DIAMatrix, b_full: jnp.ndarray,
                             free_box, full_shape,
                             bc_values: jnp.ndarray):
    """FULL lattice system -> REDUCED (BC-eliminated) lattice system by pure
    slicing — no scatters.

    The reference's reduced numbering (triapoissonserialimpl1.F:320-394 —
    free equations only, Dirichlet contributions moved to the rhs) normally
    costs a general scatter-add; when the free nodes form a contiguous
    sub-box of the generator lattice (dofs/dofmap.py:reduced_lattice), the
    reduced DIA values are a SLICE of the full DIA lattice, and the
    Dirichlet rhs correction b -= A[:, bc] u_bc is D shifted multiplies of a
    masked u_bc — everything runs at HBM bandwidth.

    Args:
      A_full: structured full-node-system DIA (lattice-shaped values).
      b_full: (n_full,) source-term rhs of the full system.
      free_box: per-axis index arrays (z0..z1, y0..y1, x0..x1 slices) of the
        free sub-box, as ((z0, nz'), (y0, ny'), (x0, nx')).
      full_shape: (nnz, nny, nnx) full node lattice.
      bc_values: (n_full,) applied Dirichlet values (0 on free nodes).
    Returns (A_red: DIAMatrix with lattice=(nz', ny', nx'), b_red).
    """
    import jax

    from pfemfort_jax.sparse.dia import decompose_offsets

    shifts = decompose_offsets(A_full.offsets, full_shape)
    assert shifts is not None, "full offsets must decompose on the lattice"
    nd = len(full_shape)
    starts = [b[0] for b in free_box]
    red_shape = tuple(b[1] for b in free_box)
    red_strides = [1] * nd
    for a in range(nd - 2, -1, -1):
        red_strides[a] = red_strides[a + 1] * red_shape[a + 1]
    n_red = int(np.prod(red_shape))

    vals_lat = A_full.vals.reshape((len(A_full.offsets),) + tuple(full_shape))
    bc_lat = bc_values.reshape(full_shape).astype(b_full.dtype)
    b_lat = b_full.reshape(full_shape)

    # pad shifted reads so boxes touching a lattice edge stay in bounds
    pads = [max((abs(int(s[a])) for s in shifts), default=0)
            for a in range(nd)]

    def box_slice(arr, extra_shift=None):
        if extra_shift is None:
            idx = tuple(slice(starts[a], starts[a] + red_shape[a])
                        for a in range(nd))
            return arr[idx]
        arrp = jnp.pad(arr, [(p, p) for p in pads])
        idx = tuple(slice(starts[a] + pads[a] + int(extra_shift[a]),
                          starts[a] + pads[a] + int(extra_shift[a])
                          + red_shape[a])
                    for a in range(nd))
        return arrp[idx]

    free_mask = jnp.zeros(full_shape, dtype=bool)
    free_mask = free_mask.at[tuple(
        slice(starts[a], starts[a] + red_shape[a])
        for a in range(nd))].set(True)

    red_offsets = []
    red_vals = []
    b_red = box_slice(b_lat)
    for d, sh in enumerate(shifts):
        o_red = sum(int(sh[a]) * red_strides[a] for a in range(nd))
        v_free = box_slice(vals_lat[d])          # (red_shape): rows r free
        # column node r + shift: free -> matrix entry; BC -> rhs correction
        col_free = box_slice(free_mask, sh)      # does the col stay in box?
        col_bc = box_slice(bc_lat, sh)           # applied value at col
        red_offsets.append(int(o_red))
        red_vals.append(jnp.where(col_free, v_free, 0.0).reshape(-1))
        b_red = b_red - v_free * jnp.where(col_free, 0.0, col_bc)

    order = np.argsort(red_offsets)
    A_red = DIAMatrix(
        vals=jnp.stack([red_vals[i] for i in order]),
        offsets=tuple(int(red_offsets[i]) for i in order),
        n_rows=n_red,
        lattice=red_shape)
    return A_red, b_red.reshape(-1)


def assemble_structured_chunked(element_fn, coords_em, plan: StructuredPlan,
                                n_chunks: int):
    """Memory-bounded structured assembly: elements processed in z-slab
    chunks inside ONE lax.fori_loop (matrix + rhs together).

    At 48M elements the one-shot path needs Ke (ns^2 E) + geometry temps
    (~18 GB) simultaneously; chunking caps the live element window at
    E/n_chunks while the (D, lattice) accumulator stays put.  Each chunk is
    a contiguous element range (hex index is z-major in the generator,
    mesh/generate.py), added with dynamic-update-slices at the traced
    z-offset — compile cost stays that of a single chunk.

    element_fn must be shape-polymorphic in E (all our kernels are).
    Requires nez % n_chunks == 0.
    """
    import jax

    nex, ney, nez = plan.nex, plan.ney, plan.nez
    nnx, nny, nnz_ = nex + 1, ney + 1, nez + 1
    ndof = plan.ndof
    ns = 4 * ndof
    D = len(plan.offsets)
    assert nez % n_chunks == 0, (nez, n_chunks)
    cnz = nez // n_chunks
    epc = cnz * ney * nex * 6          # elements per chunk
    dtype = coords_em.dtype

    def body(k, carry):
        vals, rhs = carry
        z0 = k * cnz
        ce = jax.lax.dynamic_slice_in_dim(coords_em, k * epc, epc, axis=2)
        Ke, Fe = element_fn(ce)
        Kc = Ke.reshape(ns, ns, cnz, ney, nex, 6)
        Fc = Fe.reshape(ns, cnz, ney, nex, 6)
        for (c, nr, nc, d, rz, ry, rx, ci) in plan.entries:
            blk = Kc[nr, nc, :, :, :, c]
            cur = jax.lax.dynamic_slice(
                vals, (d, rz + z0, ry, rx, ci), (1, cnz, ney, nex, 1))
            vals = jax.lax.dynamic_update_slice(
                vals, cur + blk[None, :, :, :, None],
                (d, rz + z0, ry, rx, ci))
        for (c, nr, rz, ry, rx, ci) in plan.rhs_entries:
            blk = Fc[nr, :, :, :, c]
            cur = jax.lax.dynamic_slice(
                rhs, (rz + z0, ry, rx, ci), (cnz, ney, nex, 1))
            rhs = jax.lax.dynamic_update_slice(
                rhs, cur + blk[:, :, :, None], (rz + z0, ry, rx, ci))
        return vals, rhs

    vals0 = jnp.zeros((D, nnz_, nny, nnx, ndof), dtype=dtype)
    rhs0 = jnp.zeros((nnz_, nny, nnx, ndof), dtype=dtype)
    vals, rhs = jax.lax.fori_loop(0, n_chunks, body, (vals0, rhs0))
    n = nnx * nny * nnz_ * ndof
    lattice = (nnz_, nny, nnx) if ndof == 1 else None
    A = DIAMatrix(vals=vals.reshape(D, n), offsets=plan.offsets, n_rows=n,
                  lattice=lattice)
    return A, rhs.reshape(-1)
