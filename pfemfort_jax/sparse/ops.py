"""Uniform operator interface over the sparse formats."""

from __future__ import annotations

import functools
from typing import Callable, Tuple, Union

import jax.numpy as jnp

from pfemfort_jax.sparse.dia import DIAMatrix, dia_diagonal, spmv_dia
from pfemfort_jax.sparse.formats import ELLMatrix
from pfemfort_jax.sparse.spmv import extract_diagonal, spmv_ell

Matrix = Union[DIAMatrix, ELLMatrix]


def matvec(A: Matrix) -> Callable:
    """x -> A x for either sparse format (XLA's fused forms; see
    sparse/dia.py and sparse/spmv.py)."""
    if isinstance(A, DIAMatrix):
        return functools.partial(spmv_dia, A)
    return functools.partial(spmv_ell, A)


def operator_and_diag(A: Matrix) -> Tuple[Callable, jnp.ndarray]:
    """(x -> A x, diag(A)) for either sparse format."""
    if isinstance(A, DIAMatrix):
        return matvec(A), dia_diagonal(A)
    return matvec(A), extract_diagonal(A)
