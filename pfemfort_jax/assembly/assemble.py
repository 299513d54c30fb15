"""Device-side assembly: one segment-sum per target structure.

Replaces MatSetValues/VecSetValues + MatAssemblyBegin/End
(/root/reference/src/solverpetsc.F:328-468) with pure-functional scatter-adds
whose index sets were precomputed by assembly/pattern.py.
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

from pfemfort_jax.assembly.pattern import AssemblyPattern
from pfemfort_jax.sparse.dia import DIAMatrix
from pfemfort_jax.sparse.formats import ELLMatrix


def assemble_dia_values(Ke: jnp.ndarray,
                        pattern: AssemblyPattern) -> DIAMatrix:
    """Sum element stiffness entries straight into (D, N) diagonal storage.

    Ke is element-minor (ns, ns, E).  Destinations are computed on device in
    the SAME (i, j, e) order (elementwise + a log2(D)-step searchsorted over
    the static offset table), then reduced with ONE UNSORTED segment-sum —
    no permutation gather, no
    sort, no O(n_entries) host arrays.  The final segment collects dropped
    (BC) contributions and is discarded.
    """
    assert pattern.layout == "dia"
    D = pattern.n_offsets
    N = pattern.n_rows
    edt = jnp.asarray(pattern.elem_dof_t)        # (ns, E) int32
    offsets = jnp.asarray(np.asarray(pattern.dia_offsets, dtype=np.int32))
    rows = edt[:, None, :]
    cols = edt[None, :, :]
    valid = (rows >= 0) & (cols >= 0)
    d = jnp.searchsorted(offsets, (cols - rows).astype(jnp.int32))
    dest = jnp.where(valid, d.astype(jnp.int32) * N + rows, D * N)
    sums = jax.ops.segment_sum(
        Ke.reshape(-1),
        dest.reshape(-1),
        num_segments=D * N + 1,
    )
    vals = sums[:-1].reshape(D, N)
    return DIAMatrix(offsets=pattern.dia_offsets, vals=vals, n_rows=N,
                     lattice=getattr(pattern, 'dia_lattice', None))


def assemble_ell_values(Ke: jnp.ndarray, pattern: AssemblyPattern,
                        ell_cols: jnp.ndarray) -> ELLMatrix:
    """General path: statically-permuted gather + sorted segment-sum into
    padded-ELL values."""
    assert pattern.layout == "ell"
    contrib = Ke.reshape(-1)[jnp.asarray(pattern.mat_perm)]
    sums = jax.ops.segment_sum(
        contrib,
        jnp.asarray(pattern.mat_segids),
        num_segments=pattern.mat_nsegs,
        indices_are_sorted=True,
    )
    vals = sums[:-1].reshape(pattern.n_rows, pattern.ell_k)
    return ELLMatrix(cols=ell_cols, vals=vals, n_cols=pattern.n_rows)


def assemble_matrix(Ke: jnp.ndarray, pattern: AssemblyPattern,
                    ell_cols=None) -> Union[DIAMatrix, ELLMatrix]:
    """Assemble into whichever structure the pattern selected."""
    if pattern.layout == "dia":
        return assemble_dia_values(Ke, pattern)
    if ell_cols is None:
        ell_cols = jnp.asarray(pattern.ell_cols)
    return assemble_ell_values(Ke, pattern, ell_cols)


def assemble_rhs(Fe: jnp.ndarray, pattern: AssemblyPattern) -> jnp.ndarray:
    """Scatter-add element vectors (ns, E) into the reduced rhs (n_rows,)."""
    sums = jax.ops.segment_sum(
        Fe.reshape(-1),
        jnp.asarray(pattern.rhs_dest),
        num_segments=pattern.n_rows + 1,
    )
    return sums[:-1]


def dirichlet_rhs_correction(Ke: jnp.ndarray, ubc_e: jnp.ndarray) -> jnp.ndarray:
    """Element-level Dirichlet elimination into the RHS (element-minor).

    F_e[i,e] = - sum_j K_e[i,j,e] * ubc_e[j,e]  where ubc_e carries applied
    values on BC slots and 0 on free slots — the reference's in-assembly
    elimination (/root/reference/src/triapoissonserialimpl1.F:625-637).
    Rows that are themselves BC dofs get dropped by the rhs scatter plan.
    (Unrolled over the tiny j axis — einsum would lower to a padded
    dot_general.)
    """
    ns = Ke.shape[1]
    return -sum(Ke[:, j, :] * ubc_e[j][None, :] for j in range(ns))


def scatter_full(Fe: jnp.ndarray, dest: jnp.ndarray,
                 n_full: int) -> jnp.ndarray:
    """Scatter-add element vectors into the FULL node-dof vector (explicit
    dynamics path: rhs is indexed by global node-dof, not reduced eq id —
    /root/reference/src/triaelasticityexplicit.F:1039-1054)."""
    return jax.ops.segment_sum(Fe.reshape(-1), dest, num_segments=n_full)
