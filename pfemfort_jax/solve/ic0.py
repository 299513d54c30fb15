"""IC(0) preconditioning with truncated-Neumann triangular application.

The reference's serial drivers default to PC=ILU
(/root/reference/src/triapoissonserialimpl1.F:696); its parallel default is
block-Jacobi with one ILU block per rank (solverpetsc.F:206).  Exact
triangular solves serialize the device (a sequential
dependence per row), so this module uses the standard wide-vector
reformulation (Chow-style approximate application):

  * the IC(0) FACTOR L (lower triangular, A ~= L L^T on the pattern of A)
    is computed host-side once per assembly — C++ (native.ic0) with a
    python fallback for small systems;
  * write L = D (I + T) with T strictly lower.  The APPLICATION uses the
    truncated Neumann series G_m = sum_{k<m} (-T)^k D^{-1} ~= L^{-1}, so
    one preconditioner application is 2(m-1) sparse MVs with T / T^T —
    pure gather-FMA work, no sequential dependences;
  * M^{-1} = G_m^T G_m is SPD by construction (G_m is unit-triangular times
    a positive diagonal, hence nonsingular), so CG remains valid — unlike
    ad-hoc inexact triangular sweeps.

T is stored as padded ELL; the transpose application uses a precomputed
ELL of T^T (static host work).  A bandwidth-reducing ordering (the RCM the
unstructured path already uses) keeps the truncation error small.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.sparse.dia import DIAMatrix
from pfemfort_jax.sparse.formats import ELLMatrix, round_up


def _csr_from_matrix(A, pattern=None) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, int]:
    """Host CSR (indptr, indices, vals) of a device DIA or ELL matrix."""
    if isinstance(A, DIAMatrix):
        n = A.n_rows
        vals = np.asarray(A.vals, dtype=np.float64)       # (D, N)
        offsets = np.asarray(A.offsets, dtype=np.int64)   # ascending census
        rows_l, cols_l, vals_l = [], [], []
        r = np.arange(n, dtype=np.int64)
        for d, o in enumerate(offsets):
            c = r + o
            ok = (c >= 0) & (c < n)
            rows_l.append(r[ok])
            cols_l.append(c[ok])
            vals_l.append(vals[d, ok])
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        v = np.concatenate(vals_l)
        order = np.lexsort((cols, rows))
        rows, cols, v = rows[order], cols[order], v[order]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        return indptr, cols.astype(np.int32), v, n
    # ELL with its pattern (CSR is already known)
    assert pattern is not None and pattern.layout == "ell"
    n = pattern.n_rows
    indptr, indices = pattern.indptr, pattern.indices
    row_deg = np.diff(indptr)
    within = (np.arange(pattern.nnz, dtype=np.int64)
              - np.repeat(indptr[:-1], row_deg))
    csr_row = np.repeat(np.arange(n, dtype=np.int64), row_deg)
    vals = np.asarray(A.vals, dtype=np.float64)[csr_row, within]
    return indptr, indices.astype(np.int32), vals, n


def _ic0_python(lp, li, lv):
    """Small-system fallback of native.ic0 (same in-place semantics)."""
    n = len(lp) - 1
    fixups = 0
    for i in range(n):
        r0, r1 = lp[i], lp[i + 1]
        dsum = 0.0
        for p in range(r0, r1):
            k = li[p]
            if k < i:
                s = 0.0
                a, b = r0, lp[k]
                bdiag = lp[k + 1] - 1
                while a < p and b < bdiag:
                    ca, cb = li[a], li[b]
                    if ca == cb:
                        s += lv[a] * lv[b]
                        a += 1
                        b += 1
                    elif ca < cb:
                        a += 1
                    else:
                        b += 1
                lv[p] = (lv[p] - s) / lv[bdiag]
                dsum += lv[p] * lv[p]
            else:
                d = lv[p] - dsum
                if not d > 0.0:
                    d = lv[p] if lv[p] > 0.0 else 1.0
                    fixups += 1
                lv[p] = np.sqrt(d)
    return fixups


_PY_FALLBACK_MAX_N = 200_000


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IC0Arrays:
    """Device-resident factor pieces (a pytree; pass INTO jit)."""
    t_cols: jax.Array      # (N, Kt) int32, sentinel N
    t_vals: jax.Array      # (N, Kt)
    tt_cols: jax.Array     # (N, Kt') int32
    tt_vals: jax.Array
    dinv: jax.Array        # (N,) 1 / diag(L)


def build_ic0(A, pattern=None, lane_pad: int = 8) -> Optional[IC0Arrays]:
    """Factor host-side and stage the T / T^T ELL blocks + 1/diag(L).

    Returns None when no factorization backend is available for this size
    (callers fall back to Jacobi and should say so).
    """
    indptr, indices, vals, n = _csr_from_matrix(A, pattern)
    return build_ic0_from_csr(indptr, indices, vals, n,
                              lane_pad=lane_pad, dtype=A.vals.dtype)


def build_ic0_from_csr(indptr, indices, vals, n: int, lane_pad: int = 8,
                       dtype=jnp.float32) -> Optional[IC0Arrays]:
    """CSR-input form of `build_ic0` (lets callers factor a PERMUTED
    system so the application shares the fast kernel's row space)."""
    lower = indices <= np.repeat(np.arange(n, dtype=np.int64),
                                 np.diff(indptr))
    li = indices[lower]
    lv = np.ascontiguousarray(vals[lower], dtype=np.float64)
    lp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(
        np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))[lower],
        minlength=n), out=lp[1:])

    fixups = None
    try:
        from pfemfort_jax import native

        native.ensure_built()
        fixups = native.ic0(lp, li, lv)
    except Exception:
        fixups = None
    if fixups is None:
        if n > _PY_FALLBACK_MAX_N:
            return None
        if n > 20_000:
            # the row-by-row two-pointer loop is ~O(nnz * row_nnz) python;
            # say so instead of burning silent host minutes
            import sys
            import time as _time

            t0 = _time.perf_counter()
            _ic0_python(lp, li.astype(np.int64), lv)
            print(f"[ic0] python fallback factorization (native builder "
                  f"unavailable): n={n}, {_time.perf_counter()-t0:.1f}s",
                  file=sys.stderr)
        else:
            _ic0_python(lp, li.astype(np.int64), lv)

    # L = D (I + T): T[i, j] = L[i, j] / L[i, i] for j < i
    diag = lv[lp[1:] - 1]                       # diag is last in each row
    dinv = 1.0 / diag
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(lp))
    strict = li < rows                          # strictly-lower entries
    tr, tc = rows[strict], li[strict].astype(np.int64)
    tv = lv[strict] * dinv[tr]

    def to_ell(r, c, v):
        deg = np.bincount(r, minlength=n)
        K = int(round_up(max(int(deg.max(initial=0)), 1), lane_pad))
        start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=start[1:])
        within = np.arange(len(r), dtype=np.int64) - start[r]
        cols = np.full((n, K), n, dtype=np.int32)
        vals_e = np.zeros((n, K), dtype=np.float64)
        cols[r, within] = c
        vals_e[r, within] = v
        return cols, vals_e

    t_cols, t_vals = to_ell(tr, tc, tv)
    o = np.lexsort((tr, tc))                    # transpose: sort by column
    tt_cols, tt_vals = to_ell(tc[o], tr[o], tv[o])
    dt = dtype
    return IC0Arrays(
        t_cols=jnp.asarray(t_cols), t_vals=jnp.asarray(t_vals, dtype=dt),
        tt_cols=jnp.asarray(tt_cols),
        tt_vals=jnp.asarray(tt_vals, dtype=dt),
        dinv=jnp.asarray(dinv, dtype=dt))


def _ell_mv(cols, vals, x):
    xp = jnp.concatenate([x, jnp.zeros((1,), dtype=x.dtype)])
    return jnp.sum(vals * xp[cols], axis=1)


def build_ic0_shard_blocks(cols_local: np.ndarray, vals: np.ndarray,
                           lane_pad: int = 8):
    """Per-shard IC(0) of each shard's OWN diagonal block — the reference's
    actual parallel default, PC=BJACOBI with one ILU-class factorization per
    rank (/root/reference/src/solverpetsc.F:206: block-Jacobi whose default
    sub-PC is ILU).  Ghost columns (>= P) are outside the block, exactly
    PETSc's per-rank SeqAIJ diagonal block.

    cols_local: (S, P, K) int32 local ELL columns; vals: (S*P, K) host
    values.  Returns stacked (S, ...) numpy arrays
    (t_cols, t_vals, tt_cols, tt_vals, dinv) for `ic0_block_preconditioner`,
    or None if no factorization backend covers the size.
    """
    S, P, K = cols_local.shape
    v = np.asarray(vals, dtype=np.float64).reshape(S, P, K)
    per = []
    kt_max = 1
    for s in range(S):
        c = cols_local[s].astype(np.int64)
        rows = np.arange(P, dtype=np.int64)[:, None]
        own = c < P
        lower = own & (c <= rows)
        # rows with no diagonal entry (padding) get an explicit unit pivot
        has_diag = (lower & (c == rows)).any(axis=1)
        deg = lower.sum(axis=1) + (~has_diag)
        lp = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(deg, out=lp[1:])
        li = np.empty(lp[-1], dtype=np.int32)
        lv = np.empty(lp[-1], dtype=np.float64)
        # ELL cols ascend per row among own entries, so per-row order is
        # already CSR order; diag (== row) sorts last among c <= row
        idx = np.nonzero(lower)
        order = np.lexsort((c[idx], idx[0]))
        r_sorted = idx[0][order]
        pos = (lp[r_sorted]
               + (np.arange(len(r_sorted))
                  - np.searchsorted(r_sorted, r_sorted)))
        li[pos] = c[idx][order].astype(np.int32)
        lv[pos] = v[s][idx][order]
        miss = np.nonzero(~has_diag)[0]
        li[lp[miss + 1] - 1] = miss.astype(np.int32)
        lv[lp[miss + 1] - 1] = 1.0

        fixups = None
        try:
            from pfemfort_jax import native

            fixups = native.ic0(lp, li, lv)
        except Exception:
            fixups = None
        if fixups is None:
            if P > _PY_FALLBACK_MAX_N:
                return None
            _ic0_python(lp, li.astype(np.int64), lv)

        diag = lv[lp[1:] - 1]
        dinv = 1.0 / diag
        rws = np.repeat(np.arange(P, dtype=np.int64), np.diff(lp))
        strict = li < rws
        tr, tc = rws[strict], li[strict].astype(np.int64)
        tv = lv[strict] * dinv[tr]
        per.append((tr, tc, tv, dinv))
        degt = np.bincount(tr, minlength=P)
        degtt = np.bincount(tc, minlength=P)
        kt_max = max(kt_max, int(degt.max(initial=0)),
                     int(degtt.max(initial=0)))

    Kt = int(round_up(kt_max, lane_pad))

    def to_ell(r, c, val):
        deg = np.bincount(r, minlength=P)
        start = np.zeros(P + 1, dtype=np.int64)
        np.cumsum(deg, out=start[1:])
        within = np.arange(len(r), dtype=np.int64) - start[r]
        cols_e = np.full((P, Kt), P, dtype=np.int32)
        vals_e = np.zeros((P, Kt), dtype=np.float64)
        cols_e[r, within] = c
        vals_e[r, within] = val
        return cols_e, vals_e

    t_cols = np.empty((S, P, Kt), np.int32)
    t_vals = np.empty((S, P, Kt), np.float64)
    tt_cols = np.empty((S, P, Kt), np.int32)
    tt_vals = np.empty((S, P, Kt), np.float64)
    dinv_a = np.empty((S, P), np.float64)
    for s, (tr, tc, tv, dinv) in enumerate(per):
        t_cols[s], t_vals[s] = to_ell(tr, tc, tv)
        o = np.lexsort((tr, tc))
        tt_cols[s], tt_vals[s] = to_ell(tc[o], tr[o], tv[o])
        dinv_a[s] = dinv
    return t_cols, t_vals, tt_cols, tt_vals, dinv_a


def ic0_block_apply(t_cols, t_vals, tt_cols, tt_vals, dinv, m: int = 4):
    """Shard-local M^{-1} r closure from the SLICED (P, Kt)/(P,) block
    arrays (use inside shard_map; same truncated-Neumann G^T G form)."""
    def apply(r):
        rd = dinv * r
        z = rd
        for _ in range(m - 1):
            z = rd - _ell_mv(t_cols, t_vals, z)
        w = z
        for _ in range(m - 1):
            w = z - _ell_mv(tt_cols, tt_vals, w)
        return dinv * w

    return apply


def ic0_preconditioner(arrs: IC0Arrays, m: int = 4) -> Callable:
    """r -> G_m^T G_m r (SPD; 2(m-1) ELL MVs per application)."""
    def apply(r):
        rd = arrs.dinv * r
        z = rd
        for _ in range(m - 1):                 # z ~= (I+T)^{-1} D^{-1} r
            z = rd - _ell_mv(arrs.t_cols, arrs.t_vals, z)
        w = z
        for _ in range(m - 1):                 # w ~= (I+T^T)^{-1} z
            w = z - _ell_mv(arrs.tt_cols, arrs.tt_vals, w)
        return arrs.dinv * w

    return apply
