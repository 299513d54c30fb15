"""Multi-device explicit dynamics: slab-sharded central differences.

The reference's explicit drivers are effectively single-rank (their element
ownership check is commented out and the rhs is never reduced across ranks —
triaelasticityexplicit.F:998,1056; SURVEY §3.3 'only correct on 1 rank').
This module provides what the reference intended: domain-decomposed explicit
time stepping —
  * elements and nodes are slab-partitioned with shard-contiguous numbering,
  * each step: ring-exchange displacement halos (ppermute), batched
    element residual, scatter into an extended local vector, ring-exchange
    the rhs halos back and add (the PETSc VecAssembly ghost-add, done with
    two neighbor permutes),
  * the whole time loop is one lax.scan inside shard_map.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from pfemfort_jax.dofs.dofmap import build_dofmap
from pfemfort_jax.elements.elasticity import (
    dmat_3d,
    dmat_plane_strain,
    elasticity_residual,
    lumped_mass,
)
from pfemfort_jax.elements.geometry import to_element_minor
from pfemfort_jax.dynamics.explicit import _MASS_NGP, ExplicitResult
from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.parallel.partition import slab_partition
from pfemfort_jax.sparse.formats import round_up


@dataclasses.dataclass
class ShardedExplicitSetup:
    n_shards: int
    rows_per_shard: int        # P (node-dofs per shard, padded)
    halo: int                  # W (node-dofs), halo width each side
    node_perm: np.ndarray      # old node -> new node id
    # stacked per-shard arrays (leading axis = shard)
    coords_s: np.ndarray       # (S, npe, ndim, Emax)
    dest_s: np.ndarray         # (S, ns*Emax) scatter ids into extended vec
    gather_s: np.ndarray       # (S, ns, Emax) gather ids from extended vec
    wmask_s: np.ndarray        # (S, Emax) 1.0 real / 0.0 padding element
    free_s: np.ndarray         # (S, P) free-dof mask
    probe_owner: np.ndarray    # (n_probe,) owning shard
    probe_local: np.ndarray    # (n_probe,) local index within shard


def build_sharded_explicit(mesh: Mesh, ndof: int, dirichlet: np.ndarray,
                           n_shards: int, probe_dofs: Sequence[int] = (),
                           lane_pad: int = 8) -> ShardedExplicitSetup:
    dofmap = build_dofmap(mesh, ndof, dirichlet)
    # slab partition of NODES along the longest axis, contiguous renumber
    node_part = slab_partition(mesh.coords, n_shards)
    order = np.argsort(node_part, kind="stable")
    node_perm = np.empty(mesh.n_node, dtype=np.int64)
    node_perm[order] = np.arange(mesh.n_node)
    counts = np.bincount(node_part, minlength=n_shards)
    Pn = round_up(int(counts.max()), lane_pad)
    # new padded node id: shard*Pn + rank-within-shard
    within = np.zeros(mesh.n_node, dtype=np.int64)
    start = 0
    for s in range(n_shards):
        within[order[start:start + counts[s]]] = np.arange(counts[s])
        start += counts[s]
    node_new = node_part.astype(np.int64) * Pn + within
    Prow = Pn * ndof

    # element ownership = min node part (elements stay within s..s+1 slabs)
    conn_new = node_new[mesh.conn]
    elem_part = node_part[mesh.conn].min(axis=1).astype(np.int64)
    span_elem_parts = node_part[mesh.conn].max(axis=1) - elem_part
    if span_elem_parts.max(initial=0) > 1:
        raise ValueError("an element spans more than two slabs; "
                         "use fewer shards or a finer mesh")

    Emax = int(round_up(int(np.bincount(elem_part,
                                        minlength=n_shards).max()), 1))
    npe, ndim = mesh.npe, mesh.ndim
    ns = npe * ndof

    # halo width in node-dofs: max |node - shard_base| beyond own block
    base = elem_part * Pn
    rel = conn_new - base[:, None]
    halo_nodes = max(int(np.maximum(rel - Pn + 1, 0).max(initial=0)), 0)
    W = round_up(max(halo_nodes, 1), lane_pad) * ndof

    coords_s = np.zeros((n_shards, npe, ndim, Emax))
    gather_s = np.zeros((n_shards, ns, Emax), dtype=np.int32)
    wmask_s = np.zeros((n_shards, Emax))
    ce = mesh.elem_coords()  # (E, npe, ndim)
    for s in range(n_shards):
        els = np.nonzero(elem_part == s)[0]
        k = len(els)
        coords_s[s, :, :, :k] = np.transpose(ce[els], (1, 2, 0))
        # local extended index of node-dof: (node_new - s*Pn)*ndof + d + W
        loc = (conn_new[els] - s * Pn) * ndof  # (k, npe)
        idx = (loc[:, :, None] + np.arange(ndof)[None, None, :]
               ).reshape(k, ns) + W
        gather_s[s, :, :k] = idx.T
        wmask_s[s, :k] = 1.0
        if k < Emax:  # padding elements: point at slot 0, weight 0
            gather_s[s, :, k:] = 0
            coords_s[s, :, :, k:] = coords_s[s, :, :, k - 1:k] if k else 1.0
    dest_s = gather_s.reshape(n_shards, -1)

    free_full = dofmap.free_mask_full()  # (n_node*ndof,) in OLD numbering
    free_s = np.zeros((n_shards, Prow), dtype=bool)
    free_nodes_dofs = free_full.reshape(mesh.n_node, ndof)
    s_of = node_part
    for s in range(n_shards):
        own = np.nonzero(s_of == s)[0]
        w = within[own]
        free_s[s].reshape(Pn, ndof)[w] = free_nodes_dofs[own]

    probe = np.asarray(probe_dofs, dtype=np.int64)
    pnode, pdof = probe // ndof, probe % ndof
    pnew = node_new[pnode]
    probe_owner = (pnew // Pn).astype(np.int32)
    probe_local = ((pnew % Pn) * ndof + pdof).astype(np.int32)

    return ShardedExplicitSetup(
        n_shards=n_shards, rows_per_shard=Prow, halo=W,
        node_perm=node_new, coords_s=coords_s, dest_s=dest_s,
        gather_s=gather_s, wmask_s=wmask_s, free_s=free_s,
        probe_owner=probe_owner, probe_local=probe_local)


def explicit_dynamics_sharded(
    mesh: Mesh,
    dirichlet: np.ndarray,
    E: float,
    nu: float,
    dens: float,
    dt: float,
    nsteps: int,
    device_mesh: JMesh,
    bforce_fn: Optional[Callable] = None,
    probe_dofs: Sequence[int] = (),
    thickness: float = 1.0,
    dtype=None,
) -> ExplicitResult:
    """Slab-sharded central-difference dynamics over a device mesh."""
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    ndim = mesh.ndim
    ndof = ndim
    n_shards = device_mesh.devices.size
    setup = build_sharded_explicit(mesh, ndof, dirichlet, n_shards,
                                   probe_dofs)
    Prow, W = setup.rows_per_shard, setup.halo
    ext = Prow + 2 * W
    D = dmat_plane_strain(E, nu) if ndim == 2 else dmat_3d(E, nu)
    if bforce_fn is None:
        bforce_fn = lambda t: jnp.zeros((ndim,), dtype=dtype)
    dtt = dt * dt

    def put(a, spec):
        return jax.device_put(jnp.asarray(a, dtype=None),
                              NamedSharding(device_mesh, spec))

    coords_sj = put(np.asarray(setup.coords_s, dtype=np.float64).astype(
        np.dtype(dtype)), P("shard"))
    gather_sj = put(setup.gather_s, P("shard"))
    dest_sj = put(setup.dest_s, P("shard"))
    wmask_sj = put(np.asarray(setup.wmask_s).astype(np.dtype(dtype)),
                   P("shard"))
    free_sj = put(setup.free_s, P("shard"))
    pown = jnp.asarray(setup.probe_owner)
    ploc = jnp.asarray(setup.probe_local)
    n_probe = len(setup.probe_owner)

    def ring_add(v_ext, axis):
        """Send halo segments to neighbors and add into their owned range."""
        n = jax.lax.axis_size(axis)
        left_part = v_ext[:W]       # belongs to left neighbor's tail
        right_part = v_ext[-W:]     # belongs to right neighbor's head
        from_right = jax.lax.ppermute(
            left_part, axis, [(i + 1, i) for i in range(n - 1)])
        from_left = jax.lax.ppermute(
            right_part, axis, [(i, i + 1) for i in range(n - 1)])
        own = v_ext[W:W + Prow]
        own = own.at[-W:].add(from_right)
        own = own.at[:W].add(from_left)
        return own

    def ring_halo(v_own, axis):
        """Fetch neighbors' boundary values -> extended vector."""
        n = jax.lax.axis_size(axis)
        left = jax.lax.ppermute(
            v_own[-W:], axis, [(i, i + 1) for i in range(n - 1)])
        right = jax.lax.ppermute(
            v_own[:W], axis, [(i + 1, i) for i in range(n - 1)])
        return jnp.concatenate([left, v_own, right])

    def body(coords_b, gather_b, dest_b, wmask_b, free_b):
        axis = "shard"
        coords_em = coords_b[0]
        gid = gather_b[0]
        did = dest_b[0].astype(jnp.int32)
        wm = wmask_b[0]
        free = free_b[0]

        Me = lumped_mass(coords_em, mesh.etype, dens, ndof,
                         ngp=_MASS_NGP[mesh.etype]) * wm[None, :]
        M_ext = jax.ops.segment_sum(Me.reshape(-1), did, num_segments=ext)
        M = ring_add(M_ext, axis)
        has_mass = M > 0
        upd = jnp.logical_and(free, has_mass)
        Msafe = jnp.where(has_mass, M, 1.0)

        def residual(disp_own, t):
            disp_ext = ring_halo(disp_own, axis)
            disp_em = disp_ext[gid]                 # (ns, Emax)
            Fe = elasticity_residual(
                coords_em, disp_em, mesh.etype, D, dens, bforce_fn(t),
                thickness=thickness if ndim == 2 else 1.0)
            Fe = Fe * wm[None, :]
            r_ext = jax.ops.segment_sum(Fe.reshape(-1), did,
                                        num_segments=ext)
            return ring_add(r_ext, axis)

        def step(carry, k):
            disp_prev, disp_prev2, velo_prev, _ = carry
            t = k.astype(disp_prev.dtype) * dt
            rhs = residual(disp_prev, t)
            rhs = rhs + (M / dtt) * (2.0 * disp_prev - disp_prev2)
            disp = jnp.where(upd, dtt * rhs / Msafe, 0.0)
            velo = (disp - disp_prev2) / (2.0 * dt)
            acce = (disp - 2.0 * disp_prev + disp_prev2) / dtt
            # probe extraction: each shard contributes its owned probes
            my = jax.lax.axis_index(axis)
            if n_probe:
                sel = (pown == my)
                vals = jnp.where(sel, disp[ploc], 0.0)
                vvals = jnp.where(sel, velo[ploc], 0.0)
                out = jax.lax.psum(jnp.concatenate([vals, vvals]), axis)
            else:
                out = jnp.zeros((0,), dtype=disp.dtype)
            return (disp, disp_prev, velo, acce), out

        z = jax.lax.pcast(jnp.zeros((Prow,), dtype=coords_em.dtype),
                          ("shard",), to="varying")
        carry, ys = jax.lax.scan(step, (z, z, z, z), jnp.arange(nsteps))
        disp, disp_prev, velo, acce = carry
        return disp[None], velo[None], acce[None], ys[None]

    mapped = jax.shard_map(
        body,
        mesh=device_mesh,
        in_specs=(P("shard"), P("shard"), P("shard"), P("shard"),
                  P("shard")),
        out_specs=(P("shard"), P("shard"), P("shard"), P("shard")),
    )
    disp_s, velo_s, acce_s, ys_s = jax.jit(mapped)(
        coords_sj, gather_sj, dest_sj, wmask_sj, free_sj)

    # un-permute back to the original node numbering
    disp_s = np.asarray(disp_s, dtype=np.float64).reshape(-1)
    velo_s = np.asarray(velo_s, dtype=np.float64).reshape(-1)
    acce_s = np.asarray(acce_s, dtype=np.float64).reshape(-1)
    node_new = setup.node_perm
    idx = (node_new[:, None] * ndof + np.arange(ndof)[None, :]).reshape(-1)
    disp = disp_s[idx]
    velo = velo_s[idx]
    acce = acce_s[idx]
    ys = np.asarray(ys_s)[0]  # identical on all shards after psum
    return ExplicitResult(
        disp=disp, velo=velo, acce=acce,
        probe_history=ys, times=np.arange(nsteps) * dt)
