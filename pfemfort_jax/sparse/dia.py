"""DIA (diagonal-offset) sparse format: the gather-free SpMV for
lattice-structured FEM matrices.

After lexicographic node numbering, the reduced stiffness matrix of every
structured benchmark mesh (the reference's box tet meshes, tria grids) has a
SMALL fixed set of nonzero diagonals — e.g. exactly 15 offsets for the 6-tet
split 3D Poisson matrix.  SpMV then needs NO gathers at all:

    y[i] = sum_d vals[d, i] * x[i + off_d]

i.e. D shifted element-wise FMAs over sequential memory streams, which XLA
fuses into one bandwidth-bound loop.  This replaces the gather-based ELL SpMV
(sparse/spmv.py) whenever the pattern qualifies; unstructured meshes fall
back to ELL.  (PETSc's MPIAIJ CSR — solverpetsc.F:152-166 — has no such
fast path.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIAMatrix:
    """Diagonal-offset matrix.  `offsets` and `n_rows` are static pytree aux
    (they parameterize slice shapes and must survive jit boundaries).

    `lattice`: optional static node-lattice shape with prod(lattice) ==
    n_rows.  When set, rows are points of a row-major lattice and every
    offset decomposes into a small per-axis shift — SpMV then runs as an
    N-D stencil (sliced windows of a padded x), which XLA fuses into one
    bandwidth-bound pass.  REQUIREMENT: entries that would
    wrap across a lattice row under flat 1-D indexing must be ZERO in
    `vals` (true by construction for FEM matrices assembled on the lattice:
    no element couples non-adjacent lattice points)."""

    vals: jax.Array           # (D, n_rows): vals[d, r] = A[r, r + off_d]
    offsets: Tuple[int, ...] = dataclasses.field(metadata=dict(static=True))
    n_rows: int = dataclasses.field(metadata=dict(static=True))
    lattice: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, metadata=dict(static=True))

    def _replace(self, **kw) -> "DIAMatrix":
        return dataclasses.replace(self, **kw)


def decompose_offsets(offsets: Tuple[int, ...],
                      shape: Tuple[int, ...]) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Decompose flat row-major offsets into per-axis lattice shifts.

    Returns one shift tuple per offset, or None if any offset does not
    decompose into shifts of magnitude < axis_size/2 (ambiguous / not a
    lattice stencil)."""
    strides = [1] * len(shape)
    for a in range(len(shape) - 2, -1, -1):
        strides[a] = strides[a + 1] * shape[a + 1]
    out = []
    for o in offsets:
        rem = int(o)
        shifts = []
        ok = True
        for L in reversed(shape):
            d = rem - round(rem / L) * L    # balanced remainder in (-L/2, L/2]
            if abs(d) * 2 >= L:
                ok = False
                break
            shifts.append(d)
            rem = (rem - d) // L
        if not ok or rem != 0:
            return None
        out.append(tuple(reversed(shifts)))
    return tuple(out)


def _spmv_dia_lattice(A: DIAMatrix, x: jnp.ndarray,
                      shifts: Tuple[Tuple[int, ...], ...]) -> jnp.ndarray:
    """y = A x as an N-D lattice stencil: one sliced window of a padded x
    per diagonal, all fused by XLA into a single bandwidth-bound sweep."""
    shape = A.lattice
    nd = len(shape)
    pads = [max((abs(s[a]) for s in shifts), default=0) for a in range(nd)]
    xl = x.reshape(shape)
    xp = jnp.pad(xl, [(p, p) for p in pads])
    y = jnp.zeros(shape, dtype=x.dtype)
    for d, sh in enumerate(shifts):
        starts = [pads[a] + sh[a] for a in range(nd)]
        limits = [starts[a] + shape[a] for a in range(nd)]
        xs = jax.lax.slice(xp, starts, limits)
        y = y + A.vals[d].reshape(shape) * xs
    return y.reshape(-1)


def spmv_dia(A: DIAMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = A x as D shifted FMAs (no gathers)."""
    if A.lattice is not None and min(A.lattice) >= 5:
        shifts = decompose_offsets(A.offsets, A.lattice)
        if shifts is not None:
            return _spmv_dia_lattice(A, x, shifts)
    offs = A.offsets
    neg = max(0, -min(offs))
    pos = max(0, max(offs))
    n = A.n_rows
    xpad = jnp.concatenate([
        jnp.zeros((neg,), dtype=x.dtype), x,
        jnp.zeros((pos,), dtype=x.dtype)])
    y = jnp.zeros_like(x)
    for d, o in enumerate(offs):
        xs = jax.lax.slice_in_dim(xpad, neg + o, neg + o + n)
        y = y + A.vals[d] * xs
    return y


def dia_diagonal(A: DIAMatrix) -> jnp.ndarray:
    try:
        d0 = A.offsets.index(0)
    except ValueError:
        return jnp.zeros((A.n_rows,), dtype=A.vals.dtype)
    return A.vals[d0]


def spmv_dia_local(offsets: Tuple[int, ...], vals_local: jnp.ndarray,
                   x_global: jnp.ndarray, row0) -> jnp.ndarray:
    """Shard-local DIA SpMV: rows [row0, row0+P) against a gathered global x.

    x slices start at traced row0 + static offset -> dynamic_slice, still no
    per-element gathers.
    """
    P = vals_local.shape[1]
    offs = offsets
    neg = max(0, -min(offs))
    pos = max(0, max(offs))
    xpad = jnp.concatenate([
        jnp.zeros((neg,), dtype=x_global.dtype), x_global,
        jnp.zeros((pos,), dtype=x_global.dtype)])
    y = jnp.zeros((P,), dtype=x_global.dtype)
    for d, o in enumerate(offs):
        xs = jax.lax.dynamic_slice_in_dim(xpad, row0 + (neg + o), P)
        y = y + vals_local[d] * xs
    return y
