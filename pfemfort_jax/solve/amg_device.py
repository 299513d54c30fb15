"""Device form of the algebraic preconditioners' internals.

The SA-AMG V-cycle (solve/amg.py) and the IC(0) truncated-Neumann
application (solve/ic0.py) are built from padded-ELL products.  This module
ships each static ELL block of a built hierarchy or factor to the device
once per solve as an `ELLMatrix` and applies it with the gathered ELL SpMV
(sparse/spmv.py).

Values are packed at BUILD time (preconditioner matrices are static per
solve); everything is a pytree passed INTO jit as arguments.

Reference role: PETSc PC=hypre/gamg and PC=ILU applications inside
KSPSolve (/root/reference/src/solverpetsc.F:198-209, 476).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.solve.amg import SAMGArrays, SAMGMeta
from pfemfort_jax.sparse.formats import ELLMatrix
from pfemfort_jax.sparse.spmv import spmv_ell


def build_device_ell(cols: np.ndarray, vals: np.ndarray, n_cols: int,
                     dtype=jnp.float32) -> ELLMatrix:
    """Ship one (n, K) padded-ELL block (column ids >= n_cols mark empty
    slots; n_cols may differ from n, as in the P0 / P0^T transfers)."""
    return ELLMatrix(cols=jnp.asarray(np.asarray(cols)),
                     vals=jnp.asarray(np.asarray(vals), dtype=dtype),
                     n_cols=int(n_cols))


# ---------------------------------------------------------------------------
# SA-AMG hierarchy on the device
# ---------------------------------------------------------------------------

class SAMGDevice(NamedTuple):
    """Per-level device blocks (pytree; pass INTO jit as an argument).

    Transfers are stored FACTORED: only the tentative P0 / P0^T blocks
    (1 nonzero per fine row per near-nullspace mode) plus the per-level
    smoothing weight.  The smoothing factor (I - omega D^-1 A) is applied
    through the level operator:  P ec = (I - om D^-1 A)(P0 ec)  and
    P^T rf = P0^T (I - om A D^-1) rf (A symmetric).  The smoothed P^T has
    rows as wide as a ring of A; the factored form costs one extra level
    SpMV per transfer instead."""
    ops: Tuple[ELLMatrix, ...]             # level operators
    p0: Tuple[ELLMatrix, ...]
    p0t: Tuple[ELLMatrix, ...]
    omegas: Tuple[float, ...]
    inv_diags: Tuple[jax.Array, ...]
    coarse_inv: jax.Array


def build_samg_device(arrs: SAMGArrays, sizes: Tuple[int, ...],
                      dtype=jnp.float32) -> SAMGDevice:
    """Ship every block of a built hierarchy.  `sizes`: rows per level
    (SAMGMeta.sizes)."""
    def _b(cols, vals, n_cols):
        return build_device_ell(cols, vals, n_cols=n_cols, dtype=dtype)

    nlev = len(arrs.a_cols)
    ops = [_b(arrs.a_cols[li], arrs.a_vals[li],
              int(np.asarray(arrs.a_cols[li]).shape[0]))
           for li in range(nlev)]
    p0, p0t = [], []
    for li in range(nlev - 1):
        n_f = int(np.asarray(arrs.p0_cols[li]).shape[0])
        n_c = int(np.asarray(arrs.p0t_cols[li]).shape[0])
        p0.append(_b(arrs.p0_cols[li], arrs.p0_vals[li], n_c))
        p0t.append(_b(arrs.p0t_cols[li], arrs.p0t_vals[li], n_f))
    return SAMGDevice(ops=tuple(ops), p0=tuple(p0), p0t=tuple(p0t),
                      omegas=tuple(arrs.omegas),
                      inv_diags=tuple(jnp.asarray(d, dtype=dtype)
                                      for d in arrs.inv_diags),
                      coarse_inv=jnp.asarray(arrs.coarse_inv, dtype=dtype))


def _vcycle_device(dev: SAMGDevice, meta: SAMGMeta, level: int,
                   r: jnp.ndarray, spmv0) -> jnp.ndarray:
    last = len(dev.inv_diags) - 1
    if level == last:
        return jnp.dot(dev.coarse_inv, r,
                       precision=jax.lax.Precision.HIGHEST)
    Dinv = dev.inv_diags[level]
    om = meta.omega_smooth
    om_p = dev.omegas[level]
    if level == 0 and spmv0 is not None:
        spmv = spmv0
    else:
        op = dev.ops[level]
        spmv = lambda x: spmv_ell(op, x)

    e = om * Dinv * r
    for _ in range(meta.nu - 1):
        e = e + om * Dinv * (r - spmv(e))
    # factored restriction: rc = P0^T (I - om_p A D^-1) rf
    rf = r - spmv(e)
    rc = spmv_ell(dev.p0t[level], rf - om_p * spmv(Dinv * rf))
    ec = _vcycle_device(dev, meta, level + 1, rc, None)
    # factored prolongation: e += (I - om_p D^-1 A) (P0 ec)
    pe = spmv_ell(dev.p0[level], ec)
    e = e + pe - om_p * Dinv * spmv(pe)
    for _ in range(meta.nu):
        e = e + om * Dinv * (r - spmv(e))
    return e


def samg_device_preconditioner(dev: SAMGDevice, meta: SAMGMeta,
                               spmv0: Optional[Callable] = None
                               ) -> Callable:
    """r -> M^-1 r: one symmetric V(nu, nu) cycle.  `spmv0`: the caller's
    fine operator (must be the SAME matrix in the SAME row space)."""
    def precond(r):
        return _vcycle_device(dev, meta, 0, r, spmv0)

    return precond


# ---------------------------------------------------------------------------
# IC(0) on the device
# ---------------------------------------------------------------------------

class IC0Device(NamedTuple):
    """T / T^T blocks + 1/diag(L) (pytree; pass INTO jit)."""
    t: ELLMatrix
    tt: ELLMatrix
    dinv: jax.Array


def build_ic0_device(arrs, dtype=jnp.float32) -> IC0Device:
    """Ship an IC0Arrays factor's triangular ELL blocks (solve/ic0.py)."""
    n = int(np.asarray(arrs.t_cols).shape[0])
    return IC0Device(
        t=build_device_ell(np.asarray(arrs.t_cols),
                           np.asarray(arrs.t_vals), n_cols=n, dtype=dtype),
        tt=build_device_ell(np.asarray(arrs.tt_cols),
                            np.asarray(arrs.tt_vals), n_cols=n,
                            dtype=dtype),
        dinv=jnp.asarray(arrs.dinv, dtype=dtype))


def ic0_device_preconditioner(dev: IC0Device, m: int = 4) -> Callable:
    """r -> G_m^T G_m r with 2(m-1) T/T^T products (same truncated-Neumann
    math as solve/ic0.py:ic0_preconditioner)."""
    def apply(r):
        rd = dev.dinv * r
        z = rd
        for _ in range(m - 1):
            z = rd - spmv_ell(dev.t, z)
        w = z
        for _ in range(m - 1):
            w = z - spmv_ell(dev.tt, w)
        return dev.dinv * w

    return apply
