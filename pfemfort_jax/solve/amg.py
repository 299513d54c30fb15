"""Smoothed-aggregation algebraic multigrid (serial, any SPD mesh).

The reference's scalable-preconditioner story is PETSc's options-file
escape hatch to hypre/AMG (/root/reference/src/solverpetsc.F:1-8, 198-209).
Geometric MG (solve/multigrid.py, parallel/dist_mg.py) covers the generator
lattices; THIS module covers meshes with no lattice at all — the classic
smoothed-aggregation construction (Vanek/Mandel/Brezina):

  host setup (numpy/scipy, once per assembled matrix):
    * strength graph  |a_ij| > theta * sqrt(a_ii a_jj)
    * greedy root aggregation (pass 1: free neighborhoods become
      aggregates; pass 2: leftovers attach to a strongly-connected
      neighbor aggregate; pass 3: singletons)
    * tentative P0 = piecewise-constant over aggregates (per dof
      component for vector problems, so node blocks stay decoupled)
    * smoothed P = (I - omega D^-1 A) P0, omega = 2/3 / lambda_max
      (Gershgorin bound on D^-1 A)
    * Galerkin coarse operator A_c = P^T A P (scipy sparse product)
    * recurse until the coarsest level fits a dense inverse

  device V-cycle (jit-traced, SPD):
    * damped-Jacobi pre/post smoothing (elementwise)
    * restriction/prolongation and level SpMVs as padded-ELL products
      (the P blocks are tiny next to the fine operator)

All level arrays are a pytree passed INTO jit as arguments (tens of MB of
constants would otherwise be baked into every compiled program).

The solver drivers run the V-cycle of solve/amg_device.py, which stores
the transfers FACTORED (see SAMGArrays); this module's V-cycle applies the
smoothed transfers directly.  Three scale findings are baked into the
construction:
aggressive (double) aggregation on the finest level, Galerkin filtering
with diagonal lumping from level 2 down, and a coarsening stall guard —
each fixing a measured pathology at the 857k-row flagship (docstrings at
the respective code).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.sparse.formats import round_up


# ---------------------------------------------------------------------------
# host-side setup
# ---------------------------------------------------------------------------

def _aggregate2(S_indptr, S_indices, n: int) -> Tuple[np.ndarray, int]:
    """Double (pairwise-composite) aggregation: aggregate the strength
    graph, then aggregate the AGGREGATE graph and compose — radius-2
    aggregates with ~8x the single-pass coarsening ratio and no S^2
    product (the PETSc-GAMG 'aggressive coarsening on the finest level'
    idea, done AGMG-style).  Shrinks the first coarse operator ~8x, which
    is where hierarchy build, device routing, and plane memory all
    concentrate."""
    import scipy.sparse as ssp

    agg_a, na_a = _aggregate(S_indptr, S_indices, n)
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(S_indptr))
    ra = agg_a[rows]
    ca = agg_a[S_indices]
    off = ra != ca
    Sagg = ssp.csr_matrix(
        (np.ones(int(off.sum()), np.float32), (ra[off], ca[off])),
        shape=(na_a, na_a))
    agg_b, na_b = _aggregate(Sagg.indptr, Sagg.indices.astype(np.int64),
                             na_a)
    return agg_b[agg_a], na_b


def _aggregate(S_indptr, S_indices, n: int) -> Tuple[np.ndarray, int]:
    """Greedy root aggregation over the strength graph (node granularity).

    Returns (agg_id per node (-1 never after pass 3), n_agg).  Routes to
    the C++ implementation when available (the python loop costs ~10 s at
    857k rows); both produce identical aggregates."""
    try:
        from pfemfort_jax import native

        res = native.samg_aggregate(S_indptr, S_indices, n)
        if res is not None:
            return res
    except Exception:
        pass
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    # pass 1: roots whose whole strong neighborhood is unaggregated
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = S_indices[S_indptr[i]:S_indptr[i + 1]]
        if (agg[nb] >= 0).any():
            continue
        agg[i] = n_agg
        agg[nb] = n_agg
        n_agg += 1
    # pass 2: attach leftovers to a neighboring aggregate
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = S_indices[S_indptr[i]:S_indptr[i + 1]]
        hit = nb[agg[nb] >= 0]
        if len(hit):
            agg[i] = agg[hit[0]]
    # pass 3: remaining isolated nodes become singletons
    for i in range(n):
        if agg[i] < 0:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _rigid_body_modes(coords_rows: np.ndarray, comp: np.ndarray,
                      ndof: int) -> np.ndarray:
    """Near-nullspace B (n, k) for elasticity: translations + rotations.

    coords_rows: per-ROW node coordinates; comp: per-row dof component.
    ndof=3 -> k=6 (3 translations, 3 rotations); ndof=2 -> k=3."""
    n = coords_rows.shape[0]
    x, y = coords_rows[:, 0], coords_rows[:, 1]
    z = coords_rows[:, 2] if coords_rows.shape[1] > 2 else np.zeros(n)
    cols = []
    for d in range(ndof):                      # translations
        cols.append((comp == d).astype(np.float64))
    if ndof >= 2:                              # rotation about z: (-y, x)
        cols.append(np.where(comp == 0, -y, np.where(comp == 1, x, 0.0)))
    if ndof == 3:                              # about x: (0, -z, y)
        cols.append(np.where(comp == 1, -z, np.where(comp == 2, y, 0.0)))
        # about y: (z, 0, -x)
        cols.append(np.where(comp == 0, z, np.where(comp == 2, -x, 0.0)))
    return np.stack(cols, axis=1)


def _tentative_from_nullspace(agg_of_row: np.ndarray, n_agg: int,
                              B: np.ndarray):
    """Aggregate-wise QR of the near-nullspace: P0 (n, n_agg*k) with the
    orthonormal Q blocks, and the coarse nullspace Bc (n_agg*k, k) from
    the R factors (the standard SA recursion).  Rank-deficient aggregates
    (too few rows for k modes) keep zero columns — the guarded coarsest
    inverse treats the resulting zero coarse rows as identity."""
    import scipy.sparse as ssp

    n, k = B.shape
    order = np.argsort(agg_of_row, kind="stable")
    sizes = np.bincount(agg_of_row, minlength=n_agg)
    starts = np.zeros(n_agg + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    rows_sorted = order
    P0_rows, P0_cols, P0_vals = [], [], []
    Bc = np.zeros((n_agg * k, k), dtype=np.float64)
    # bucket aggregates by size: one BATCHED QR per size class
    for m in np.unique(sizes):
        if m == 0:
            continue
        aggs = np.nonzero(sizes == m)[0]
        idx = (starts[aggs][:, None]
               + np.arange(m)[None, :])        # (n_aggs_m, m)
        rws = rows_sorted[idx]                 # member rows per aggregate
        Bb = B[rws]                            # (n_aggs_m, m, k)
        Q, R = np.linalg.qr(Bb)                # reduced: (m, min(m,k))
        kk = Q.shape[2]
        # zero out columns whose pivot is ~0 (rank deficiency)
        piv = np.abs(R[:, np.arange(kk), np.arange(kk)])
        scale = np.maximum(np.abs(R).max(axis=(1, 2), keepdims=False),
                           1e-300)
        ok = piv > 1e-10 * scale[:, None]      # (n_aggs_m, kk)
        Q = np.where(ok[:, None, :], Q, 0.0)
        R = np.where(ok[:, :, None], R, 0.0)
        P0_rows.append(np.broadcast_to(rws[:, :, None],
                                       (len(aggs), m, kk)).ravel())
        P0_cols.append((aggs[:, None, None] * k
                        + np.arange(kk)[None, None, :]
                        + np.zeros((1, m, 1), np.int64)).ravel())
        P0_vals.append(Q.ravel())
        rows_bc = (aggs[:, None] * k + np.arange(kk)[None, :]).ravel()
        Bc[rows_bc] = R.reshape(len(aggs) * kk, k)
    P0 = ssp.csr_matrix(
        (np.concatenate(P0_vals),
         (np.concatenate(P0_rows), np.concatenate(P0_cols))),
        shape=(n, n_agg * k))
    return P0, Bc


def _csr_to_ell(S, lane_pad: int = 8):
    """scipy CSR -> padded-ELL numpy (cols sentinel = n_cols)."""
    S = S.tocsr()
    n, m = S.shape
    deg = np.diff(S.indptr)
    K = int(round_up(max(int(deg.max(initial=0)), 1), lane_pad))
    cols = np.full((n, K), m, dtype=np.int32)
    vals = np.zeros((n, K), dtype=S.dtype)
    within = np.arange(S.nnz, dtype=np.int64) - np.repeat(S.indptr[:-1], deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    cols[rows, within] = S.indices
    vals[rows, within] = S.data
    return cols, vals


class SAMGArrays(NamedTuple):
    """Per-level device data (pytree; pass INTO jit).

    The SMOOTHED prolongator P = (I - omega D^-1 A) P0 is stored two
    ways: directly (p/pt ELLs — the portable V-cycle's form) and FACTORED
    (p0/p0t tentative ELLs + omega) so device cycles can apply the
    smoothing factor through the level operator's fast kernel and route
    only the skinny 1-nonzero-per-fine-row tentative blocks — the
    smoothed P^T has ring-of-A-wide rows, so every transfer would gather
    a whole ring of A per coarse row."""
    a_cols: Tuple[jax.Array, ...]     # level operators, padded ELL
    a_vals: Tuple[jax.Array, ...]
    p_cols: Tuple[jax.Array, ...]     # prolongators fine->coarse, ELL
    p_vals: Tuple[jax.Array, ...]
    pt_cols: Tuple[jax.Array, ...]    # restrictions (P^T), ELL
    pt_vals: Tuple[jax.Array, ...]
    p0_cols: Tuple[jax.Array, ...]    # TENTATIVE prolongators P0, ELL
    p0_vals: Tuple[jax.Array, ...]
    p0t_cols: Tuple[jax.Array, ...]   # P0^T, ELL
    p0t_vals: Tuple[jax.Array, ...]
    omegas: Tuple[float, ...]         # per-level smoothing weight omega_p
    inv_diags: Tuple[jax.Array, ...]
    coarse_inv: jax.Array             # dense inverse of the coarsest level


@dataclasses.dataclass(frozen=True)
class SAMGMeta:
    sizes: Tuple[int, ...]            # rows per level
    nu: int
    omega_smooth: float               # Jacobi damping in the cycle


def build_samg(indptr: np.ndarray, indices: np.ndarray, vals: np.ndarray,
               n: int, ndof: int = 1, theta: float = 0.08,
               coarsest_max: int = 800, max_levels: int = 12,
               nu: Optional[int] = None,
               omega_smooth: Optional[float] = None,
               node_block: int = 1,
               nullspace: Optional[np.ndarray] = None,
               min_coarsen_ratio: float = 1.5,
               filter_tol: float = 0.01,
               filter_from_level: int = 2,
               aggressive_levels: int = 0,
               dtype=jnp.float32) -> Optional[Tuple[SAMGArrays, SAMGMeta]]:
    """Build the hierarchy from a host CSR of the (reduced, SPD) system.

    `node_block` > 1: rows come in aligned blocks of that size (every node
    owns node_block consecutive rows — the distributed shard layout
    guarantees this, parallel/shard.py); aggregation then runs on the NODE
    graph and the tentative prolongator keeps one column per aggregate per
    COMPONENT, preserving the vector structure (translations as the near-
    nullspace).  With node_block=1 (solve_implicit's reduced numbering has
    no alignment guarantee) aggregation is dof-granular — still a valid
    SPD preconditioner, just weaker coarse spaces for vector problems."""
    import scipy.sparse as ssp

    # ndof-aware smoothing (same finding as parallel/dist_mg.py): vector
    # problems need nu=2 sweeps at omega=0.6 — measured 43 -> 16 iterations
    # on a 4-shard elasticity box vs the scalar defaults
    if nu is None:
        nu = 1 if ndof == 1 else 2
    if omega_smooth is None:
        omega_smooth = 0.7 if ndof == 1 else 0.6

    # size-adaptive coarsest: every extra level adds fixed V-cycle latency
    # (its applies cost kernel overhead, not bandwidth, at a few thousand
    # rows), while the dense coarsest inverse is nearly free to apply —
    # stop sooner on big problems (cap respects the 8192 dense guard)
    coarsest_max = min(max(coarsest_max, n // 200), 6000)
    A = ssp.csr_matrix((vals, indices, indptr), shape=(n, n))
    nb = node_block if (node_block > 1 and n % node_block == 0) else 1
    B_ns = None
    if nullspace is not None and nb > 1:
        B_ns = np.asarray(nullspace, dtype=np.float64)
        assert B_ns.shape[0] == n
    levels_a: List = [A]
    levels_p: List = []
    levels_p0: List = []
    sizes = [n]
    while sizes[-1] > coarsest_max and len(sizes) < max_levels:
        Al = levels_a[-1].tocsr()
        nl = Al.shape[0]
        d = np.asarray(Al.diagonal(), dtype=np.float64)
        d_safe = np.where(d > 0, d, 1.0)
        # strength-of-connection filter
        rows = np.repeat(np.arange(nl, dtype=np.int64), np.diff(Al.indptr))
        cols = Al.indices.astype(np.int64)
        av = np.abs(np.asarray(Al.data, dtype=np.float64))
        nbl = nb if (nb > 1 and nl % nb == 0) else 1
        # aggressive (double) aggregation on the finest level(s):
        # ~8x deeper first coarsening, concentrating where routing
        # and Galerkin cost live (PETSc-GAMG default behavior)
        aggf = (_aggregate2 if len(sizes) <= aggressive_levels
                else _aggregate)
        # theta backoff: Galerkin densification makes deep coarse operators
        # diagonally dominant — a fixed strength threshold can leave the
        # graph EMPTY (every node becomes its own aggregate = no progress);
        # retry with a weaker threshold, then with all off-diag connections
        made_progress = False
        for th_try in (theta, 0.1 * theta, 0.0):
            thr = th_try * np.sqrt(d_safe[rows] * d_safe[cols])
            keep = (av > thr) & (rows != cols)
            if nbl > 1:
                rb_p = rows[keep] // nbl
                cb_p = cols[keep] // nbl
                off_p = rb_p != cb_p
                Sp = ssp.csr_matrix(
                    (np.ones(int(off_p.sum()), np.float32),
                     (rb_p[off_p], cb_p[off_p])),
                    shape=(nl // nbl, nl // nbl))
                _, na_p = aggf(Sp.indptr,
                                     Sp.indices.astype(np.int64),
                                     nl // nbl)
                if na_p * min_coarsen_ratio <= nl // nbl:
                    made_progress = True
                    break
            else:
                Sp = ssp.csr_matrix(
                    (np.ones(int(keep.sum()), np.float32),
                     (rows[keep], cols[keep])), shape=(nl, nl))
                _, na_p = aggf(Sp.indptr,
                                     Sp.indices.astype(np.int64), nl)
                if na_p * min_coarsen_ratio <= nl:
                    made_progress = True
                    break
        if not made_progress:
            break
        if nbl > 1:
            # condense to the node-block graph, aggregate nodes, expand the
            # tentative prolongator per component
            rb_, cb_ = rows[keep] // nbl, cols[keep] // nbl
            off = rb_ != cb_
            S = ssp.csr_matrix(
                (np.ones(int(off.sum()), np.float32),
                 (rb_[off], cb_[off])), shape=(nl // nbl, nl // nbl))
            agg_n, n_agg_n = aggf(S.indptr,
                                        S.indices.astype(np.int64),
                                        nl // nbl)
            # STALL GUARD: near-singleton aggregation densifies every
            # deeper Galerkin operator geometrically (measured: 20
            # csr_matmat calls = 222 s of a 237 s hierarchy build at 103k
            # rows) — stop and let the dense coarsest
            # inverse absorb this level instead
            if n_agg_n * min_coarsen_ratio > nl // nbl:
                break
            r_all = np.arange(nl, dtype=np.int64)
            if B_ns is not None:
                # classic SA recursion: aggregate-wise QR of the carried
                # near-nullspace (rigid-body modes on the fine level)
                P0, B_next = _tentative_from_nullspace(
                    agg_n[r_all // nbl], n_agg_n, B_ns)
                n_agg = P0.shape[1]
                B_ns = B_next
                nb = B_ns.shape[1]        # coarse blocks = k modes
            else:
                agg_cols = agg_n[r_all // nbl] * nbl + (r_all % nbl)
                n_agg = n_agg_n * nbl
                P0 = ssp.csr_matrix(
                    (np.ones(nl, np.float64), (r_all, agg_cols)),
                    shape=(nl, n_agg))
        else:
            S = ssp.csr_matrix((np.ones(int(keep.sum()), np.float32),
                                (rows[keep], cols[keep])), shape=(nl, nl))
            agg, n_agg = aggf(S.indptr, S.indices.astype(np.int64),
                                    nl)
            if n_agg * min_coarsen_ratio > nl:   # stall guard (see above)
                break
            # tentative piecewise-constant prolongator
            P0 = ssp.csr_matrix(
                (np.ones(nl, np.float64),
                 (np.arange(nl, dtype=np.int64), agg)), shape=(nl, n_agg))
        absrow = np.asarray(np.abs(Al).sum(axis=1)).reshape(-1)
        lam = float(np.max(absrow / d_safe))       # Gershgorin on D^-1 A
        omega_p = (4.0 / 3.0) / max(lam, 1e-30)
        Dinv = ssp.diags(1.0 / d_safe)
        P = (P0 - omega_p * (Dinv @ (Al @ P0))).tocsr()
        Ac = (P.T @ Al @ P).tocsr()
        Ac.sum_duplicates()
        if filter_tol > 0 and len(sizes) >= filter_from_level:
            # Galerkin operator filtering (the PETSc-GAMG/hypre truncation
            # idea): smoothing densifies coarse operators geometrically —
            # measured 624 nnz/row at level 2 of the 857k flagship, which
            # wrecks both the next products and any gather plan.  Drop
            # |a_ij| < tol*sqrt(a_ii a_jj) off-diagonals and LUMP them
            # into the diagonal (preserves row sums, hence the action on
            # the near-nullspace; keeps SPD at these tolerances).  The
            # FIRST coarse operator is kept exact (filter_from_level) and
            # the tolerance is deliberately mild: the quality cliff is
            # sharp (tol sweep at n=32: 0.01 -> 21 iters, 0.02 -> 197)
            # while even 0.01 cuts the deep-level K ~10x (720 -> 72).
            dA = np.asarray(Ac.diagonal(), dtype=np.float64)
            ds = np.sqrt(np.abs(np.where(dA != 0, dA, 1.0)))
            rw = np.repeat(np.arange(Ac.shape[0], dtype=np.int64),
                           np.diff(Ac.indptr))
            cw = Ac.indices.astype(np.int64)
            av = np.asarray(Ac.data, dtype=np.float64)
            drop = ((np.abs(av) < filter_tol * ds[rw] * ds[cw])
                    & (rw != cw))
            if drop.any():
                lump = np.zeros(Ac.shape[0], dtype=np.float64)
                np.add.at(lump, rw[drop], av[drop])
                keep = ~drop
                Ac = ssp.csr_matrix(
                    (av[keep], (rw[keep], cw[keep])), shape=Ac.shape)
                Ac = (Ac + ssp.diags(lump)).tocsr()
                Ac.sum_duplicates()
        levels_p.append(P)
        levels_p0.append((P0.tocsr(), omega_p))
        levels_a.append(Ac)
        sizes.append(n_agg)

    if len(sizes) == 1:
        return None                # could not coarsen at all
    if sizes[-1] > max(4 * coarsest_max, 8192):
        return None                # stuck while still too big for a dense
        #                            coarsest inverse (8k^2 f32 = 256 MB)

    a_cols, a_vals, p_cols, p_vals, pt_cols, pt_vals, inv_d = \
        [], [], [], [], [], [], []
    p0_cols, p0_vals, p0t_cols, p0t_vals, omegas = [], [], [], [], []
    for li, Al in enumerate(levels_a):
        c, v = _csr_to_ell(Al)
        a_cols.append(jnp.asarray(c))
        a_vals.append(jnp.asarray(v, dtype=dtype))
        d = np.asarray(Al.diagonal(), dtype=np.float64)
        dinv = np.zeros_like(d)
        np.divide(1.0, d, out=dinv, where=d != 0)
        inv_d.append(jnp.asarray(dinv, dtype=dtype))
    for P in levels_p:
        c, v = _csr_to_ell(P)
        p_cols.append(jnp.asarray(c))
        p_vals.append(jnp.asarray(v, dtype=dtype))
        ct, vt = _csr_to_ell(P.T.tocsr())
        pt_cols.append(jnp.asarray(ct))
        pt_vals.append(jnp.asarray(vt, dtype=dtype))
    for P0, om_p in levels_p0:
        c, v = _csr_to_ell(P0)
        p0_cols.append(jnp.asarray(c))
        p0_vals.append(jnp.asarray(v, dtype=dtype))
        ct, vt = _csr_to_ell(P0.T.tocsr())
        p0t_cols.append(jnp.asarray(ct))
        p0t_vals.append(jnp.asarray(vt, dtype=dtype))
        omegas.append(float(om_p))
    Ad = np.asarray(levels_a[-1].toarray(), dtype=np.float64)
    dz = np.abs(np.diag(Ad)) < 1e-290       # padding/empty aggregates
    if dz.any():
        Ad[dz, :] = 0.0
        Ad[:, dz] = 0.0
        Ad[dz, dz] = 1.0
    coarse_inv = jnp.asarray(np.linalg.inv(Ad), dtype=dtype)

    arrays = SAMGArrays(
        a_cols=tuple(a_cols), a_vals=tuple(a_vals),
        p_cols=tuple(p_cols), p_vals=tuple(p_vals),
        pt_cols=tuple(pt_cols), pt_vals=tuple(pt_vals),
        p0_cols=tuple(p0_cols), p0_vals=tuple(p0_vals),
        p0t_cols=tuple(p0t_cols), p0t_vals=tuple(p0t_vals),
        omegas=tuple(omegas),
        inv_diags=tuple(inv_d), coarse_inv=coarse_inv)
    meta = SAMGMeta(sizes=tuple(sizes), nu=nu, omega_smooth=omega_smooth)
    return arrays, meta


# ---------------------------------------------------------------------------
# device V-cycle
# ---------------------------------------------------------------------------

def _ell_mv(cols, vals, x):
    xp = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
    return jnp.sum(vals * xp[cols], axis=1)


def _vcycle(arrs: SAMGArrays, meta: SAMGMeta, level: int,
            r: jnp.ndarray) -> jnp.ndarray:
    last = len(arrs.a_cols) - 1
    if level == last:
        return jnp.dot(arrs.coarse_inv, r,
                       precision=jax.lax.Precision.HIGHEST)
    Dinv = arrs.inv_diags[level]
    om = meta.omega_smooth
    spmv = lambda x: _ell_mv(arrs.a_cols[level], arrs.a_vals[level], x)

    e = om * Dinv * r
    for _ in range(meta.nu - 1):
        e = e + om * Dinv * (r - spmv(e))
    rc = _ell_mv(arrs.pt_cols[level], arrs.pt_vals[level], r - spmv(e))
    ec = _vcycle(arrs, meta, level + 1, rc)
    e = e + _ell_mv(arrs.p_cols[level], arrs.p_vals[level], ec)
    for _ in range(meta.nu):
        e = e + om * Dinv * (r - spmv(e))
    return e


def samg_preconditioner(arrs: SAMGArrays, meta: SAMGMeta) -> Callable:
    """r -> M^-1 r: one symmetric V(nu, nu) cycle (SPD; valid inside CG)."""
    def precond(r):
        return _vcycle(arrs, meta, 0, r)

    return precond


# ---------------------------------------------------------------------------
# distributed form: sharded fine smoothing + replicated algebraic tail
# ---------------------------------------------------------------------------

class DistSAMG(NamedTuple):
    """Fine level split per shard; levels 1+ replicated (pytree).

    The fine operator itself is NOT here — the distributed CG already has
    it (the per-shard ELL + pairwise ghost exchange).  Transfers are
    FACTORED (see SAMGArrays): only the skinny TENTATIVE prolongator row
    blocks are stored, and the smoothing factor (I - om0 D^-1 A) is
    applied through the distributed CG's own fine halo SpMV.
    Restriction: shard s computes P0_s^T of its smoothed residual as one
    segment-sum over its tentative rows' coarse columns, and ONE psum of
    the O(N_coarse) coarse residual replicates it — O(N/coarsening)
    traffic between devices per application instead of an all_gather of
    the FULL fine residual.  The tail runs redundantly on every shard (the
    replicated-coarse pattern of parallel/dist_mg.py, but algebraic) as
    device ELL blocks (solve/amg_device.py)."""
    p0_cols_s: jax.Array          # (S, P, K0) tentative row blocks
    p0_vals_s: jax.Array
    om0: float                    # level-0 prolongator smoothing weight
    tail: SAMGArrays              # hierarchy from level 1 down


def build_dist_samg(indptr, indices, vals, n_rows_padded: int,
                    n_shards: int, ndof: int = 1,
                    coords_rows: Optional[np.ndarray] = None,
                    comp_rows: Optional[np.ndarray] = None,
                    dtype=jnp.float32, **kw
                    ) -> Optional[Tuple[DistSAMG,
                                        Tuple[SAMGMeta, SAMGMeta]]]:
    """Build the global SA hierarchy from the shard-ordered padded system
    (zero padding rows aggregate to singletons and never couple) and split
    the fine prolongator by shard-row ownership.  The shard layout is
    node-aligned for ndof > 1 (parallel/shard.py), so aggregation runs on
    the node graph; with per-row coordinates the tentative prolongators
    carry the full rigid-body near-nullspace (translations + rotations)."""
    ns = None
    if ndof > 1 and coords_rows is not None and comp_rows is not None:
        ns = _rigid_body_modes(np.asarray(coords_rows),
                               np.asarray(comp_rows), ndof)
    built = build_samg(indptr, indices, vals, n_rows_padded, ndof=ndof,
                       node_block=ndof, nullspace=ns, dtype=dtype, **kw)
    if built is None:
        return None
    arrs, meta = built
    if len(arrs.a_cols) < 2:
        return None
    P_rows = n_rows_padded // n_shards
    p_cols = np.asarray(arrs.p0_cols[0])
    p_vals = np.asarray(arrs.p0_vals[0])
    p_cols_s = p_cols.reshape(n_shards, P_rows, -1)
    p_vals_s = p_vals.reshape(n_shards, P_rows, -1)
    tail = SAMGArrays(
        a_cols=arrs.a_cols[1:], a_vals=arrs.a_vals[1:],
        p_cols=arrs.p_cols[1:], p_vals=arrs.p_vals[1:],
        pt_cols=arrs.pt_cols[1:], pt_vals=arrs.pt_vals[1:],
        p0_cols=arrs.p0_cols[1:], p0_vals=arrs.p0_vals[1:],
        p0t_cols=arrs.p0t_cols[1:], p0t_vals=arrs.p0t_vals[1:],
        omegas=arrs.omegas[1:],
        inv_diags=arrs.inv_diags[1:], coarse_inv=arrs.coarse_inv)
    dist = DistSAMG(
        p0_cols_s=jnp.asarray(p_cols_s), p0_vals_s=jnp.asarray(p_vals_s),
        om0=float(arrs.omegas[0]), tail=tail)
    tail_meta = SAMGMeta(sizes=meta.sizes[1:], nu=meta.nu,
                         omega_smooth=meta.omega_smooth)
    return dist, (meta, tail_meta)


def dist_samg_preconditioner(p0_cols_l, p0_vals_l, om0, tail_dev, metas,
                             inv_diag_l, spmv_l: Callable,
                             axis: str) -> Callable:
    """r_l -> M^-1 r_l inside shard_map.  `spmv_l`: the shard-local fine
    operator (the distributed CG's own halo SpMV); `p0_cols_l/p0_vals_l`:
    THIS shard's TENTATIVE prolongator row block (serves both transfer
    directions); `tail_dev`: the replicated device-routed tail
    (solve/amg_device.py:SAMGDevice).  Build OUTSIDE the CG loop.

    Factored transfers:  P^T rf = P0^T (I - om0 A D^-1) rf  as one extra
    halo SpMV + a K0-wide local segment-sum + one psum of the O(N_coarse)
    vector;  P ec = (I - om0 D^-1 A)(P0 ec)  as a K0-wide local gather +
    one halo SpMV.  Comms per application: 2*(nu+1) halo exchanges + one
    O(N_coarse) psum — no all_gather of the fine vector anywhere."""
    meta, tail_meta = metas
    om = meta.omega_smooth
    n_coarse = int(tail_meta.sizes[0])

    def precond(r_l):
        from pfemfort_jax.solve.amg_device import _vcycle_device

        e = om * inv_diag_l * r_l
        for _ in range(meta.nu - 1):
            e = e + om * inv_diag_l * (r_l - spmv_l(e))
        rf = r_l - spmv_l(e)
        rf2 = rf - om0 * spmv_l(inv_diag_l * rf)
        contrib = jax.ops.segment_sum(
            (p0_vals_l * rf2[:, None]).reshape(-1),
            jnp.clip(p0_cols_l, 0, n_coarse).reshape(-1),
            num_segments=n_coarse + 1)[:n_coarse]
        rc = jax.lax.psum(contrib, axis)
        ec = _vcycle_device(tail_dev, tail_meta, 0, rc, None)
        pe = _ell_mv(p0_cols_l, p0_vals_l, ec)
        e = e + pe - om0 * inv_diag_l * spmv_l(pe)
        for _ in range(meta.nu):
            e = e + om * inv_diag_l * (r_l - spmv_l(e))
        return e

    return precond
