"""Distributed (per-shard) implicit assembly inside shard_map.

The reference's core parallel design is each MPI rank assembling ONLY its own
elements, with off-rank matrix/vector entries stashed and exchanged during
MatAssemblyBegin/End (/root/reference/src/triapoissonparallelimpl1.F:849-905,
solverpetsc.F:447-468).  Here, for the DIA layout:

  * equations get shard-contiguous numbering (parallel/shard.py), so shard s
    owns rows [s*P, (s+1)*P);
  * every element is assigned to the shard of its MINIMUM row.  Because every
    (row, col) entry of an element is a pair of the element's own equations,
    the element's full row span is bounded by the matrix bandwidth
    W = max|DIA offset| -- so all of its entries land in [base, base + P + W)
    for ANY partition;
  * each shard scatter-adds its own element block into an extended local
    (D, P + W) DIA slab + (P + W) rhs, then ONE ring `ppermute` sends the
    [P, P+W) spill to the right neighbor (the PETSc stash exchange, done as a
    single deterministic collective);
  * per-device peak memory is O(E/S + P) -- full-size coords/Ke/A never exist
    on any one device.

Only rows/cols enter here; the element kernels run unchanged on the
per-shard coordinate blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np

from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.parallel.halo import halo_width
from pfemfort_jax.parallel.shard import ShardedSystem, build_sharded_system


@dataclasses.dataclass
class DistSetup:
    """Host-side per-shard element blocks for distributed DIA assembly."""
    sys: ShardedSystem
    offsets: Tuple[int, ...]      # DIA offsets over padded shard-ordered rows
    w: int                        # halo width (rows), lane-padded
    emax: int                     # padded elements per shard
    coords_s: np.ndarray          # (S, npe, ndim, Emax) float64
    edt_s: np.ndarray             # (S, ns, Emax) int32 LOCAL rows, -1 = drop
    ubc_s: np.ndarray             # (S, ns, Emax) float64 applied BC values
    elem_owner: np.ndarray        # (E,) shard that assembles each element

    @property
    def n_shards(self) -> int:
        return self.sys.n_shards

    @property
    def rows_per_shard(self) -> int:
        return self.sys.rows_per_shard


def build_dist_setup(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    n_shards: int,
    method: str = "slab",
    lane_pad: int = 8,
) -> DistSetup:
    """Build per-shard element blocks over a shard-contiguous DIA pattern.

    Raises ValueError when the pattern is not DIA-structured or the halo
    exceeds a shard (callers fall back to the replicated-assembly path).
    """
    sys_ = build_sharded_system(mesh, ndof, dirichlet, n_shards,
                                method=method, lane_pad=lane_pad,
                                layout="dia")
    pattern = sys_.pattern
    if pattern.layout != "dia":
        raise ValueError("pattern is not DIA-structured")
    offsets = pattern.dia_offsets
    w = halo_width(offsets, lane_pad)
    P = sys_.rows_per_shard
    if w > P:
        raise ValueError(f"halo width {w} exceeds shard rows {P}")

    edt = pattern.elem_dof_t                     # (ns, E) padded global rows
    ns, E = edt.shape
    valid = edt >= 0
    # Owner = shard of the element's minimum valid row; all its entries then
    # lie in [owner*P, owner*P + P + w).  All-BC elements contribute nothing.
    min_row = np.where(valid, edt, np.iinfo(np.int32).max).min(axis=0)
    owner = np.where(min_row < np.iinfo(np.int32).max,
                     np.minimum(min_row // P, n_shards - 1),
                     0).astype(np.int32)

    counts = np.bincount(owner, minlength=n_shards)
    emax = max(int(counts.max()), 1)

    npe, ndim = mesh.npe, mesh.ndim
    ce = mesh.elem_coords()                      # (E, npe, ndim)
    dofmap = sys_.dofmap
    ubc_full = dofmap.bc_values_full[dofmap.elem_nodedof]  # (E, ns)

    coords_s = np.empty((n_shards, npe, ndim, emax), dtype=np.float64)
    edt_s = np.full((n_shards, ns, emax), -1, dtype=np.int32)
    ubc_s = np.zeros((n_shards, ns, emax), dtype=np.float64)
    # padding elements reuse element 0's geometry (finite Ke, all rows -1)
    coords_s[:] = ce[0][:, :, None]              # (npe, ndim, 1) broadcast
    for s in range(n_shards):
        els = np.nonzero(owner == s)[0]
        k = len(els)
        if k:
            coords_s[s, :, :, :k] = np.transpose(ce[els], (1, 2, 0))
            loc = edt[:, els].astype(np.int64)
            edt_s[s, :, :k] = np.where(loc >= 0, loc - s * P, -1)
            ubc_s[s, :, :k] = ubc_full[els].T
    return DistSetup(sys=sys_, offsets=offsets, w=w, emax=emax,
                     coords_s=coords_s, edt_s=edt_s, ubc_s=ubc_s,
                     elem_owner=owner)


def assemble_dia_local(Ke, Fe, edt_local, offsets, P: int, w: int, axis: str):
    """Per-shard DIA assembly + one-ppermute ghost reduction (device-side).

    Ke (ns, ns, Emax), Fe (ns, Emax), edt_local (ns, Emax) local rows in
    [0, P + w) or -1.  Returns (vals_own (D, P), b_own (P,)).
    Runs INSIDE shard_map over `axis`.
    """
    import jax
    import jax.numpy as jnp

    D = len(offsets)
    ext = P + w
    offs = jnp.asarray(np.asarray(offsets, dtype=np.int32))
    rows = edt_local[:, None, :]
    cols = edt_local[None, :, :]
    valid = (rows >= 0) & (cols >= 0)
    d = jnp.searchsorted(offs, (cols - rows).astype(jnp.int32))
    dest = jnp.where(valid, d.astype(jnp.int32) * ext + rows, D * ext)
    vals_ext = jax.ops.segment_sum(
        Ke.reshape(-1), dest.reshape(-1),
        num_segments=D * ext + 1)[:-1].reshape(D, ext)
    rdest = jnp.where(edt_local >= 0, edt_local, ext)
    b_ext = jax.ops.segment_sum(
        Fe.reshape(-1), rdest.reshape(-1), num_segments=ext + 1)[:-1]

    # spill [P, P+w) belongs to the right neighbor's rows [0, w)
    n = jax.lax.axis_size(axis)
    perm = [(i, i + 1) for i in range(n - 1)]
    recv_v = jax.lax.ppermute(vals_ext[:, P:], axis, perm)
    recv_b = jax.lax.ppermute(b_ext[P:], axis, perm)
    vals_own = vals_ext[:, :P].at[:, :w].add(recv_v)
    b_own = b_ext[:P].at[:w].add(recv_b)
    return vals_own, b_own
