"""Distributed (per-shard) implicit assembly for UNSTRUCTURED meshes.

The reference assembles element-partitioned on ANY METIS-partitioned mesh:
each rank loops over its own elements and off-rank matrix/vector entries are
stashed and exchanged during MatAssemblyBegin/End
(/root/reference/src/triapoissonparallelimpl1.F:849-905,
solverpetsc.F:447-468).  parallel/dist_assembly.py covers the lattice (DIA)
case with a one-ppermute ring exchange; this module is the general-graph
analog over the padded-ELL layout:

  * equations get shard-contiguous numbering (parallel/shard.py) from an
    RCB/greedy element partition, so shard s owns rows [s*P, (s+1)*P);
  * each element is assembled by its partition's shard; entries whose ROW
    belongs to another shard are ghost entries (the PETSc stash);
  * host side, every (shard -> shard) pair gets a static send plan: the
    unique ghost (row, col) slots it contributes, compacted into a fixed
    [w_mat | w_rhs] send window.  Device side the whole per-shard scatter
    (own ELL values + own rhs + all send windows) is ONE sorted segment-sum;
  * one `all_to_all` collective delivers every shard's windows (the
    MatAssemblyBegin/End neighbor exchange, done as a single deterministic
    collective between devices), and two small segment-sums fold the received
    entries into the owner's local ELL block / rhs;
  * per-device peak memory is O(E/S + P*K) — full-size coords/Ke/A never
    exist on any one device.

The element kernels run unchanged on the per-shard coordinate blocks; the
solve is the existing all_gather ELL distributed CG (parallel/shard_cg.py).
"""

from __future__ import annotations

import dataclasses


import numpy as np

from pfemfort_jax.mesh.core import Mesh
from pfemfort_jax.parallel.shard import ShardedSystem, build_sharded_system
from pfemfort_jax.sparse.formats import round_up


@dataclasses.dataclass
class DistELLSetup:
    """Host-side per-shard element blocks + exchange plan (static)."""
    sys: ShardedSystem
    ell_k: int                 # K
    w_mat: int                 # matrix send slots per (src, dst) pair
    w_rhs: int                 # rhs send slots per pair
    emax: int                  # padded elements per shard
    coords_s: np.ndarray       # (S, npe, ndim, Emax) float64
    ubc_s: np.ndarray          # (S, ns, Emax) float64 applied BC values
    perm_s: np.ndarray         # (S, n_ent) int32 sorted-scatter permutation
    segids_s: np.ndarray       # (S, n_ent) int32 sorted segment ids
    recv_mat_dest: np.ndarray  # (S, S, w_mat) int32 local ELL slot or P*K
    recv_rhs_dest: np.ndarray  # (S, S, w_rhs) int32 local row or P
    elem_owner: np.ndarray     # (E,)

    @property
    def n_shards(self) -> int:
        return self.sys.n_shards

    @property
    def rows_per_shard(self) -> int:
        return self.sys.rows_per_shard

    @property
    def w_pair(self) -> int:
        return self.w_mat + self.w_rhs


def build_dist_ell_setup(
    mesh: Mesh,
    ndof: int,
    dirichlet: np.ndarray,
    n_shards: int,
    method: str = "rcb",
    lane_pad: int = 8,
) -> DistELLSetup:
    """Partition elements, renumber rows shard-contiguously, and precompute
    the per-shard scatter + pairwise ghost-exchange plan over the global
    padded-ELL pattern.  Works for ANY mesh/partition (no bandwidth or
    structure requirements)."""
    sys_ = build_sharded_system(mesh, ndof, dirichlet, n_shards,
                                method=method, lane_pad=lane_pad,
                                layout="ell")
    pattern = sys_.pattern
    S = n_shards
    P = sys_.rows_per_shard
    K = pattern.ell_k
    n_rows = sys_.n_rows_padded

    # shard-ordered element rows (E, ns); -1 = dropped (Dirichlet) slot
    elem_dof = sys_.dofmap.elem_dof
    mapped = np.where(elem_dof >= 0,
                      sys_.eq_perm[np.clip(elem_dof, 0, None)],
                      -1).astype(np.int64)
    E, ns = mapped.shape

    # CSR -> padded-ELL slot lookup over sorted (row, col) keys
    indptr, indices = pattern.indptr, pattern.indices
    row_deg = np.diff(indptr)
    within = (np.arange(pattern.nnz, dtype=np.int64)
              - np.repeat(indptr[:-1], row_deg))
    csr_row = np.repeat(np.arange(n_rows, dtype=np.int64), row_deg)
    uk = csr_row * n_rows + indices          # sorted unique (row, col) keys

    owner = sys_.elem_part.astype(np.int64)
    counts = np.bincount(owner, minlength=S)
    emax = max(int(counts.max()), 1)

    npe, ndim = mesh.npe, mesh.ndim
    ce = mesh.elem_coords()                  # (E, npe, ndim)
    ubc_full = sys_.dofmap.bc_values_full[sys_.dofmap.elem_nodedof]  # (E, ns)

    coords_s = np.empty((S, npe, ndim, emax), dtype=np.float64)
    ubc_s = np.zeros((S, ns, emax), dtype=np.float64)
    coords_s[:] = ce[0][:, :, None]          # padding reuses element 0

    # ---- pass 1: per-shard entry destinations + ghost collections ---------
    per_shard = []
    for s in range(S):
        els = np.nonzero(owner == s)[0]
        k = len(els)
        if k:
            coords_s[s, :, :, :k] = np.transpose(ce[els], (1, 2, 0))
            ubc_s[s, :, :k] = ubc_full[els].T

        edt = mapped[els].T                  # (ns, k)
        rows = np.broadcast_to(edt[:, None, :], (ns, ns, k))
        cols = np.broadcast_to(edt[None, :, :], (ns, ns, k))
        valid = (rows >= 0) & (cols >= 0)
        pos = np.searchsorted(uk, np.where(valid,
                                           rows * n_rows + cols, 0))
        pos = np.clip(pos, 0, len(uk) - 1)
        lflat = ((csr_row[pos] % P) * K + within[pos]).astype(np.int64)
        trow = np.where(valid, rows // P, -1)

        # rhs rows
        rvalid = edt >= 0
        r_t = np.where(rvalid, edt // P, -1)
        r_lrow = np.where(rvalid, edt % P, 0)

        per_shard.append(dict(
            k=k, valid=valid, lflat=lflat, trow=trow,
            rvalid=rvalid, r_t=r_t, r_lrow=r_lrow))

    # ---- global send-window widths -----------------------------------------
    def _pair_unique(s, tgt, loc, space):
        """Unique (target, local-id) ghost slots for shard s; returns
        (uniq_t, uniq_loc, slot_within_target, inverse)."""
        key = tgt * space + loc
        uniq, inv = np.unique(key, return_inverse=True)
        ut = uniq // space
        ul = uniq % space
        cnts = np.bincount(ut, minlength=S)
        starts = np.zeros(S, dtype=np.int64)
        np.cumsum(cnts[:-1], out=starts[1:])
        slot = np.arange(len(uniq), dtype=np.int64) - starts[ut]
        return ut, ul, slot, inv, int(cnts.max(initial=0))

    mat_ghost, rhs_ghost = [], []
    w_mat = w_rhs = 0
    for s in range(S):
        d = per_shard[s]
        gm = d["valid"] & (d["trow"] != s)
        mg = _pair_unique(s, d["trow"][gm], d["lflat"][gm], P * K)
        gr = d["rvalid"] & (d["r_t"] != s)
        rg = _pair_unique(s, d["r_t"][gr], d["r_lrow"][gr], P)
        mat_ghost.append((gm, mg))
        rhs_ghost.append((gr, rg))
        w_mat = max(w_mat, mg[4])
        w_rhs = max(w_rhs, rg[4])
    w_mat = round_up(max(w_mat, 1), lane_pad)
    w_rhs = round_up(max(w_rhs, 1), lane_pad)
    W = w_mat + w_rhs

    # destination id space per shard (one sorted segment-sum):
    #   [0, P*K)                     own ELL values
    #   [P*K, P*K + S*W)             send windows (t*W + slot | +w_mat)
    #   [P*K + S*W, .. + P)          own rhs rows
    #   last segment                 dropped (Dirichlet/pad) contributions
    base_send = P * K
    base_rhs = P * K + S * W
    sentinel = base_rhs + P
    n_ent = ns * ns * emax + ns * emax

    perm_s = np.empty((S, n_ent), dtype=np.int64)
    segids_s = np.empty((S, n_ent), dtype=np.int64)
    recv_mat_dest = np.full((S, S, w_mat), P * K, dtype=np.int64)
    recv_rhs_dest = np.full((S, S, w_rhs), P, dtype=np.int64)

    for s in range(S):
        d = per_shard[s]
        k = d["k"]
        gm, (ut, ul, slot, inv, _) = mat_ghost[s]
        gr, (rt, rl, rslot, rinv, _) = rhs_ghost[s]

        mdest = np.full((ns, ns, emax), sentinel, dtype=np.int64)
        own = d["valid"] & (d["trow"] == s)
        blk = np.full((ns, ns, k), sentinel, dtype=np.int64)
        blk[own] = d["lflat"][own]
        blk[gm] = base_send + d["trow"][gm] * W + slot[inv]
        mdest[:, :, :k] = blk
        recv_mat_dest[ut, s, slot] = ul

        rdest = np.full((ns, emax), sentinel, dtype=np.int64)
        rblk = np.full((ns, k), sentinel, dtype=np.int64)
        rown = d["rvalid"] & (d["r_t"] == s)
        rblk[rown] = base_rhs + d["r_lrow"][rown]
        rblk[gr] = base_send + d["r_t"][gr] * W + w_mat + rslot[rinv]
        rdest[:, :k] = rblk
        recv_rhs_dest[rt, s, rslot] = rl

        dest_all = np.concatenate([mdest.reshape(-1), rdest.reshape(-1)])
        perm = np.argsort(dest_all, kind="stable")
        perm_s[s] = perm
        segids_s[s] = dest_all[perm]

    idx = np.int32 if sentinel + 1 < 2**31 and n_ent < 2**31 else np.int64
    return DistELLSetup(
        sys=sys_, ell_k=K, w_mat=w_mat, w_rhs=w_rhs, emax=emax,
        coords_s=coords_s, ubc_s=ubc_s,
        perm_s=perm_s.astype(idx), segids_s=segids_s.astype(idx),
        recv_mat_dest=recv_mat_dest.astype(idx),
        recv_rhs_dest=recv_rhs_dest.astype(idx),
        elem_owner=owner.astype(np.int32))


def build_ell_halo(setup: DistELLSetup):
    """Static ghost-exchange plan for the distributed ELL SpMV.

    The all_gather form ships O(N) values per CG iteration; with an
    element-partition the columns a shard actually reads from others are its
    partition SURFACE.  Per (owner s -> reader t) pair we precompute the
    unique requested columns; per iteration each shard gathers its requested
    rows into a (S, Wx) window and ONE all_to_all delivers every ghost
    value — the PETSc VecScatter of MatMult as a single collective.

    Returns (cols_local (S, P, K) int32, send_rows (S, S, Wx) int32, Wx):
      * cols_local: own columns -> [0, P); ghost columns -> P + s*Wx + slot;
        padding -> P + S*Wx (a zero slot);
      * send_rows[s, t, slot]: the local row (in s) whose x value shard t
        wants at ghost slot `slot`.
    """
    sys_ = setup.sys
    S, P, K = setup.n_shards, sys_.rows_per_shard, setup.ell_k
    n_rows = sys_.n_rows_padded
    cols = sys_.pattern.ell_cols.reshape(S, P, K).astype(np.int64)

    per_t = []
    wx = 1
    for t in range(S):
        c = cols[t]
        ghost = (c != n_rows) & (c // P != t)
        uniq = np.unique(c[ghost])                 # sorted: owner-major
        owners = uniq // P
        cnts = np.bincount(owners, minlength=S)
        starts = np.zeros(S, dtype=np.int64)
        np.cumsum(cnts[:-1], out=starts[1:])
        per_t.append((c, ghost, uniq, owners, starts))
        wx = max(wx, int(cnts.max(initial=0)))
    wx = round_up(wx, 8)

    cols_local = np.empty((S, P, K), dtype=np.int64)
    send_rows = np.zeros((S, S, wx), dtype=np.int64)
    pad_slot = P + S * wx
    for t in range(S):
        c, ghost, uniq, owners, starts = per_t[t]
        slot_within = np.arange(len(uniq), dtype=np.int64) - starts[owners]
        # send_rows is indexed [owner s][reader t][slot]
        send_rows[owners, t, slot_within] = uniq % P
        ghost_slot = P + owners * wx + slot_within
        lut = dict(zip(uniq.tolist(), ghost_slot.tolist()))
        out = np.where(c == n_rows, pad_slot, c - t * P)
        gpos = np.nonzero(ghost)
        out[gpos] = [lut[int(v)] for v in c[gpos]]
        cols_local[t] = out
    return (cols_local.astype(np.int32), send_rows.astype(np.int32),
            int(wx))


def spmv_ell_halo(vals_l, cols_local_l, send_rows_l, x_l, axis: str):
    """y_l = (A x)_l with the pairwise ghost exchange (inside shard_map).

    vals_l/cols_local_l (P, K); send_rows_l (S, Wx); x_l (P,).
    """
    import jax
    import jax.numpy as jnp

    send = x_l[send_rows_l]                        # (S, Wx)
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0)
    xg = jnp.concatenate([x_l, recv.reshape(-1),
                          jnp.zeros((1,), dtype=x_l.dtype)])
    return jnp.sum(vals_l * xg[cols_local_l], axis=1)


def assemble_ell_local(Ke, Fe, perm, segids, recv_mat_dest, recv_rhs_dest,
                       P: int, K: int, w_mat: int, w_rhs: int, axis: str):
    """Per-shard ELL assembly + one-all_to_all ghost exchange (device-side).

    Ke (ns, ns, Emax), Fe (ns, Emax); perm/segids are this shard's sorted
    scatter plan over [own ELL | send windows | own rhs | dropped].
    Returns (vals_own (P, K), b_own (P,)).  Runs INSIDE shard_map.
    """
    import jax
    import jax.numpy as jnp

    S = jax.lax.axis_size(axis)
    W = w_mat + w_rhs
    base_send = P * K
    base_rhs = P * K + S * W
    nseg = base_rhs + P + 1

    v_all = jnp.concatenate([Ke.reshape(-1), Fe.reshape(-1)])
    sums = jax.ops.segment_sum(v_all[perm], segids,
                               num_segments=nseg, indices_are_sorted=True)
    vals_own = sums[:base_send]
    send = sums[base_send:base_rhs].reshape(S, W)
    b_own = sums[base_rhs:-1]

    # the stash exchange: one collective; recv[j] = shard j's window for me
    recv = jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0)

    mv = jax.ops.segment_sum(
        recv[:, :w_mat].reshape(-1), recv_mat_dest.reshape(-1),
        num_segments=P * K + 1)[:-1]
    rv = jax.ops.segment_sum(
        recv[:, w_mat:].reshape(-1), recv_rhs_dest.reshape(-1),
        num_segments=P + 1)[:-1]
    return (vals_own + mv).reshape(P, K), b_own + rv
