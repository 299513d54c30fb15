"""Halo-exchange SpMV for row-sharded DIA matrices.

The reference's PETSc MatMult scatters ghost values between MPI neighbors
inside KSPSolve (SURVEY §2.5-2.6).  Here, with shard-contiguous row
numbering, a DIA matrix's off-shard reads are exactly the last/first W rows
of the ring neighbors (W = max |diagonal offset|).  The exchange is two
`ppermute` shifts of W values between devices — O(W) per shard instead of
the all_gather's O(N) — and XLA can overlap the permute with the interior
FMAs.

Requires W <= rows_per_shard (one-neighbor halos); callers fall back to the
all_gather path otherwise.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def halo_width(offsets: Tuple[int, ...], lane_pad: int = 8) -> int:
    w = max(max(offsets), -min(offsets), 0)
    return ((w + lane_pad - 1) // lane_pad) * lane_pad


def exchange_halos(x_local: jnp.ndarray, w: int, axis: str):
    """Return (left_halo (w,), right_halo (w,)) from ring neighbors.

    left_halo = last w rows of the left neighbor (zeros on shard 0),
    right_halo = first w rows of the right neighbor (zeros on the last).
    """
    n = jax.lax.axis_size(axis)
    # send my tail to my right neighbor -> they receive their left halo
    tail = x_local[-w:]
    head = x_local[:w]
    left = jax.lax.ppermute(tail, axis,
                            [(i, i + 1) for i in range(n - 1)])
    right = jax.lax.ppermute(head, axis,
                             [(i + 1, i) for i in range(n - 1)])
    return left, right


def spmv_dia_halo(offsets: Tuple[int, ...], vals_local: jnp.ndarray,
                  x_local: jnp.ndarray, w: int, axis: str,
                  overlap: bool = True) -> jnp.ndarray:
    """y_local = (A x)_local with one-neighbor halo exchange.

    vals_local: (D, P) shard rows of the DIA values; x_local: (P,).
    Row r (global row0+r) needs x[global r + o] = x_ext[w + r + o] where
    x_ext = [left_halo, x_local, right_halo] — all static slices.

    With overlap=True the interior rows [w, P-w) are computed from x_local
    only, with NO data dependency on the ppermutes — XLA schedules the
    boundary exchange concurrently with the interior FMAs (the SpMV/comms
    overlap PETSc does with VecScatterBegin/End around the interior MatMult).
    """
    P = x_local.shape[0]
    left, right = exchange_halos(x_local, w, axis)
    if not overlap or P <= 2 * w:
        x_ext = jnp.concatenate([left, x_local, right])
        y = jnp.zeros_like(x_local)
        for d, o in enumerate(offsets):
            xs = jax.lax.slice_in_dim(x_ext, w + o, w + o + P)
            y = y + vals_local[d] * xs
        return y

    mid = P - 2 * w
    # interior rows r in [w, P-w): x index r+o in [0, P) — purely local
    y_mid = jnp.zeros((mid,), dtype=x_local.dtype)
    for d, o in enumerate(offsets):
        xs = jax.lax.slice_in_dim(x_local, w + o, w + o + mid)
        y_mid = y_mid + vals_local[d, w:P - w] * xs

    x_ext = jnp.concatenate([left, x_local, right])
    y_top = jnp.zeros((w,), dtype=x_local.dtype)
    y_bot = jnp.zeros((w,), dtype=x_local.dtype)
    for d, o in enumerate(offsets):
        y_top = y_top + vals_local[d, :w] \
            * jax.lax.slice_in_dim(x_ext, w + o, w + o + w)
        y_bot = y_bot + vals_local[d, P - w:] \
            * jax.lax.slice_in_dim(x_ext, P + o, P + o + w)
    return jnp.concatenate([y_top, y_mid, y_bot])


def lattice_halo_plan(offsets: Tuple[int, ...],
                      lattice: Tuple[int, ...]):
    """Static plan for the stencil form of the sharded DIA SpMV.

    Returns (shifts, wp) — per-offset per-axis lattice shifts and the halo
    depth in PLANES — or None when the offsets do not decompose into a
    lattice stencil (then callers use the 1-D shifted-slice form).
    """
    from pfemfort_jax.sparse.dia import decompose_offsets

    if lattice is None or len(lattice) < 2 or min(lattice) < 5:
        return None
    shifts = decompose_offsets(offsets, lattice)
    if shifts is None:
        return None
    wp = max((abs(s[0]) for s in shifts), default=0)
    return shifts, max(wp, 1)


def spmv_dia_halo_lattice(shifts, vals_local: jnp.ndarray,
                          x_local: jnp.ndarray, lattice: Tuple[int, ...],
                          wp: int, axis: str) -> jnp.ndarray:
    """y_local = (A x)_local as an N-D lattice stencil on the shard's
    z-slab (requires plane-aligned shard rows; parallel/shard.py).

    The halo exchange ships wp whole planes to/from the ring neighbors;
    every diagonal then becomes one sliced window of the padded slab —
    the same fused sweep as sparse/dia.py:_spmv_dia_lattice.  Entries that
    would wrap across a lattice row are zero by FEM construction.
    """
    plane_shape = tuple(lattice[1:])
    plane = 1
    for s in plane_shape:
        plane *= s
    P = x_local.shape[0]
    pz = P // plane
    nd = len(lattice)

    left, right = exchange_halos(x_local, wp * plane, axis)
    x_ext = jnp.concatenate([left, x_local, right]).reshape(
        (pz + 2 * wp,) + plane_shape)
    pads = [wp] + [max((abs(s[a]) for s in shifts), default=0)
                   for a in range(1, nd)]
    xp = jnp.pad(x_ext, [(0, 0)] + [(p, p) for p in pads[1:]])
    shape_l = (pz,) + plane_shape
    y = jnp.zeros(shape_l, dtype=x_local.dtype)
    for d, sh in enumerate(shifts):
        starts = [pads[a] + sh[a] for a in range(nd)]
        starts[0] = wp + sh[0]
        limits = [starts[a] + shape_l[a] for a in range(nd)]
        xs = jax.lax.slice(xp, starts, limits)
        y = y + vals_local[d].reshape(shape_l) * xs
    return y.reshape(-1)
